#!/usr/bin/env python
"""Measure the host-side .bed block pipeline rate vs thread count.

Staging rides PCIe (seconds for a biobank pass), so the host read+clean
pipeline — read_packed_block -> packed_col_stats -> imputation draw ->
clean_packed — can become the wall-clock bound of a precompute pass.
This measures each stage and the fused total, in packed MB/s, for a
ladder of C++ reader thread counts.

NOTE on caching: re-reading a file that fits in page cache measures the
memory-backed rate (an upper bound for warm runs); the cold-disk rate is
bounded separately by the raw device. Both are reported: the script
times a first pass over `--span_gb` of UNSEEN file range when the file
is large enough to have uncached tail ranges.

Usage: python scripts/bench_host_read.py --prefix /root/bench_data/e2e_300000_500000 -N 300000 -M 500000
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pyrhe_tpu.io.bed import BedFile, clean_packed  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prefix", required=True)
    ap.add_argument("-N", type=int, required=True)
    ap.add_argument("-M", type=int, required=True)
    ap.add_argument("--threads", default="1,2,4,8")
    ap.add_argument("--span_gb", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    bps = (args.N + 3) // 4
    m_span = int(min(args.M, args.span_gb * 1e9 // bps))
    rng = np.random.default_rng(0)

    for nt in (int(t) for t in args.threads.split(",")):
        bed = BedFile(args.prefix + ".bed", args.N, args.M, num_threads=nt)
        # one contiguous span, timed per stage
        s = int(rng.integers(0, max(1, args.M - m_span)))
        t0 = time.perf_counter()
        # np.array forces the copy out of the mmap (read_packed_block
        # returns a lazy view; without this the page-fault cost would
        # leak into the col_stats timing)
        packed = np.array(bed.read_packed_block(s, s + m_span))
        t_read = time.perf_counter() - t0
        # CPU stages on RESIDENT memory, best of 2 (first call pays LUT
        # init / cold code paths)
        t_stats = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            sums, nmiss = bed.packed_col_stats(packed)
            t_stats = min(t_stats, time.perf_counter() - t0)
        rs = np.random.RandomState(args.seed)
        rval = rs.random_sample(m_span)
        p = np.divide(sums, args.N - nmiss,
                      out=np.zeros_like(sums), where=(args.N - nmiss) > 0
                      ) * 0.5
        fill = np.where(rval < (1 - p) ** 2, 0.0,
                        np.where(rval < (1 - p) ** 2 + 2 * p * (1 - p),
                                 1.0, 2.0))
        out = np.empty((m_span, ((args.N + 3) // 4 + 511) // 512 * 512),
                       np.uint8)
        out.fill(0)   # pre-touch: first-touch page faults must not land
        # inside the clean timing (production reuses staged buffers)
        t_clean = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            clean_packed(packed, fill, out=out, num_threads=nt)
            t_clean = min(t_clean, time.perf_counter() - t0)
        mb = m_span * bps / 1e6
        total = t_read + t_stats + t_clean
        print(json.dumps({
            "threads": nt, "span_mb": round(mb, 1),
            "read_mb_s": round(mb / t_read, 1),
            "col_stats_mb_s": round(mb / t_stats, 1),
            "clean_mb_s": round(mb / t_clean, 1),
            "pipeline_mb_s": round(mb / total, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
