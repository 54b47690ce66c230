#!/usr/bin/env python
"""End-to-end wall-clock benchmark: synthesize (once) a biobank-style
dataset and time the full estimation pipeline phase by phase.

Comparison point (BASELINE.md): reference PyRHE, N=200k / ~500k SNPs,
k=10, J=100, 5 CPU workers = 450.53 s; C++ RHE-mc = 845.10 s.

The first host transfer pays the backend's session setup — it is timed
separately as `warmup`; phase timings force a device sync via
device_get.

Usage:
    python scripts/bench_e2e.py [-N 50000] [-M 100000] [-k 10] [-jn 100]
        [--streaming] [--dir /tmp/e2e] [--model rhe]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-N", type=int, default=50000)
    ap.add_argument("-M", type=int, default=100000)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("-jn", type=int, default=100)
    ap.add_argument("--model", default="rhe",
                    choices=["rhe", "rhe_dom", "genie"])
    ap.add_argument("--genie_model", default="G",
                    choices=["G", "G+GxE", "G+GxE+NxE"],
                    help="GENIE component set (an env column is "
                         "synthesized alongside the dataset when needed)")
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--dir", default="/tmp/pyrhe_e2e")
    ap.add_argument("--checkpoint_dir", default=None,
                    help="crash-safe resume snapshots for the long "
                         "target-scale runs (BASELINE N=300k/M=500k)")
    ap.add_argument("--stage_streams", type=int, default=1)
    ap.add_argument("--pheno", default=None,
                    help="phenotype file override (e.g. an NA-bearing "
                         "variant for a filtered-vs-complete row)")
    ap.add_argument("--cache_blocks", type=int, default=-1,
                    help="hybrid stats-cache split (RunConfig.cache_blocks)")
    ap.add_argument("--cold_read", action="store_true",
                    help="drop the OS page cache before the run so host "
                         ".bed reads hit real storage (root only)")
    args = ap.parse_args()

    import jax

    from pyrhe_tpu.core.data import load_dataset
    from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig
    from pyrhe_tpu.io import synth

    os.makedirs(args.dir, exist_ok=True)
    prefix = os.path.join(args.dir, f"e2e_{args.N}_{args.M}")
    times = {}

    if not os.path.exists(prefix + ".bed"):
        t0 = time.time()
        if args.N * args.M > 10**8:   # large scale: one-pass synthesis
            synth.make_dataset_fast(prefix, args.N, args.M, [0.3], seed=9,
                                    missing_rate=0.01)
        else:
            synth.make_dataset(prefix, args.N, args.M, seed=9,
                               missing_rate=0.01)
            annot = synth.make_annot(prefix + ".annot", args.M, 1, seed=9)
            synth.simulate_pheno_file(prefix, prefix, [0.3], annot, seed=10)
        times["synthesize"] = time.time() - t0

    t0 = time.time()
    _ = jax.device_get(jax.device_put(np.ones(4, np.float32),
                                      jax.devices()[0]))
    times["warmup"] = time.time() - t0

    if args.cold_read:
        # measured-cold contract: every .bed byte of this run comes off
        # storage, not the page cache (sync first so dirty pages cannot
        # satisfy reads either)
        os.system("sync")
        try:
            with open("/proc/sys/vm/drop_caches", "w") as f:
                f.write("3\n")
        except OSError as e:
            print(f"WARNING: could not drop caches ({e}); "
                  "cold_read row would be invalid", file=sys.stderr)
            return 1

    env_file = None
    if args.model == "genie" and "GxE" in args.genie_model:
        env_file = prefix + ".env"
        if not os.path.exists(env_file):
            synth.make_env_file(env_file, args.N, num_env=1, seed=11)

    t0 = time.time()
    data = load_dataset(prefix, annot_file=prefix + ".annot",
                        pheno_file=args.pheno or prefix + ".pheno",
                        env_file=env_file,
                        num_random_vec=args.k, seed=1)
    spec = ModelSpec.build(args.model, args.genie_model, data.num_env)
    eng = Engine(data, spec, RunConfig(num_random_vec=args.k,
                                       num_jack=args.jn, seed=1,
                                       streaming=args.streaming,
                                       cache_blocks=args.cache_blocks,
                                       checkpoint_dir=args.checkpoint_dir,
                                       stage_streams=args.stage_streams))
    times["load+init"] = time.time() - t0

    t0 = time.time()
    eng.precompute()
    _ = jax.device_get(eng._tot[0][:1, :1, :1])   # true sync
    times["precompute"] = time.time() - t0

    t0 = time.time()
    eng.assemble()
    times["assemble"] = time.time() - t0

    t0 = time.time()
    sj, st = eng.estimate(0)
    times["solve"] = time.time() - t0
    times["total_after_warmup"] = sum(
        v for k, v in times.items() if k not in ("warmup", "synthesize"))

    print(json.dumps({
        "N": args.N, "M": args.M, "k": args.k, "J": args.jn,
        "model": (args.model if args.model != "genie"
                  else f"genie:{args.genie_model}"),
        "streaming": args.streaming,
        "cache_blocks": args.cache_blocks, "cold_read": args.cold_read,
        "backend": jax.devices()[0].platform,
        "sigma": np.round(st, 5).tolist(),
        "phases_s": {k: round(v, 2) for k, v in times.items()},
        # overlapped sub-phases (prefetch thread): host .bed read+clean,
        # host->device staging incl. transfer sync, device scan dispatch
        "engine_phases_s": {k: round(v, 2)
                            for k, v in eng.phase_times.items()},
    }))


if __name__ == "__main__":
    main()
