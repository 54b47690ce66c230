#!/usr/bin/env python
"""Sweep many phenotypes over one genotype dataset (the role of the
reference's test_real.py, which loops 50 UKBB phenotypes by editing a
shared INI config under an fcntl lock and launching one process each —
re-reading the genotypes for every phenotype).

This version amortizes the genome pass twice over:
  - every trait column inside one file shares a single engine precompute
    (each residualized trait rides the probe matrix, engine.py docstring);
  - phenotype FILES with identical missing-individual sets are MERGED
    into one multi-trait pass (same filtering -> same probe matrix ->
    identical per-trait estimates to an individual run; guarded by
    tests/test_sweep.py), so a 50-file UKBB sweep with complete
    phenotypes pays ONE genome pass, not 50. Files whose missing sets
    differ get their own group (filtering changes the kept cohort).

Results are collected into a summary JSON compatible with
parse_output.py's schema, plus one report .txt per input file.

Usage:
    python scripts/sweep_phenotypes.py -g data/geno -annot data/snps.annot \
        --pheno_glob 'phenos/*.pheno' -o results/ [-c covar.cov] [-k 10]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def group_pheno_files(files: list[str]):
    """Group phenotype files by (row count, missing-individual set).

    Files in one group drop the same individuals, so their traits can
    share a single engine pass. Returns a list of groups, each a list of
    paths (input order preserved within and across groups)."""
    from pyrhe_tpu.io.readers import read_pheno

    groups: dict[tuple, list[str]] = {}
    for path in files:
        y, missing, _ = read_pheno(path)
        groups.setdefault((y.shape[0], tuple(missing)), []).append(path)
    return list(groups.values())


def merge_pheno_files(paths: list[str], out_path: str):
    """Write a single `FID IID <traits...>` file concatenating every
    group member's trait columns (column names prefixed by file stem to
    stay unique). Every member must list the SAME individuals in the
    SAME order — merging is purely row-positional, so a reordered file
    would silently attach traits to the wrong IDs otherwise. Returns the
    per-file trait counts, in path order."""
    fids = None
    headers: list[str] = []
    bodies: list[list[list[str]]] = []
    n_traits: list[int] = []
    for p in paths:
        with open(p) as f:
            lines = [ln.split() for ln in f.read().splitlines()
                     if ln.strip()]
        hdr, rows = lines[0], lines[1:]
        ids = [(r[0], r[1]) for r in rows]
        if fids is None:
            fids = ids
        elif ids != fids:
            raise ValueError(
                f"{p} lists different (or differently ordered) FID/IID "
                f"rows than {paths[0]}; cannot merge into one pass")
        stem = os.path.splitext(os.path.basename(p))[0]
        headers.extend(f"{stem}_{h}" for h in hdr[2:])
        bodies.append([r[2:] for r in rows])
        n_traits.append(len(hdr) - 2)
    with open(out_path, "w") as f:
        f.write("FID IID " + " ".join(headers) + "\n")
        for i, (fid, iid) in enumerate(fids):
            vals = [v for b in bodies for v in b[i]]
            f.write(f"{fid} {iid} " + " ".join(vals) + "\n")
    return n_traits


def run_sweep(args) -> dict:
    from pyrhe_tpu import RHE, StreamingRHE
    from pyrhe_tpu.utils.logger import Logger

    os.makedirs(args.output_dir, exist_ok=True)
    summary: dict = {}
    files = sorted(glob.glob(args.pheno_glob))
    if not files:
        sys.exit(f"no phenotype files match {args.pheno_glob}")
    cls = StreamingRHE if args.streaming else RHE
    groups = ([[p] for p in files] if args.no_merge
              else group_pheno_files(files))
    print(f"{len(files)} phenotype files -> {len(groups)} genome "
          f"pass(es)", flush=True)

    for gi, group in enumerate(groups):
        if len(group) == 1:
            pheno_path = group[0]
            with open(pheno_path) as f:
                traits_per_file = [len(f.readline().split()) - 2]
        else:
            pheno_path = os.path.join(args.output_dir,
                                      f"_merged_group{gi}.pheno")
            traits_per_file = merge_pheno_files(group, pheno_path)
        model = cls(geno_file=args.genotype, annot_file=args.annotation,
                    pheno_file=pheno_path, cov_file=args.covariate,
                    num_jack=args.num_block, num_random_vec=args.num_vec,
                    seed=args.seed)
        trait0 = 0
        for path, nt in zip(group, traits_per_file):
            name = os.path.splitext(os.path.basename(path))[0]
            # per-file wall time: the group's shared precompute lands in
            # the FIRST file's runtime (where the lazy engine pass runs),
            # later files report only their near-free solve time
            t_file = time.time()
            # per-file report: swap in a fresh logger so each input file
            # gets its own .txt with only its trait sections. The engine
            # captured the ctor-time logger (models/base.py), so retarget
            # it too — otherwise engine notices (stats-cache cap, hybrid
            # or streaming switch, checkpoint resume) vanish from every
            # saved report
            model.log = Logger(suppress=True, debug_mode=False)
            model.engine.log = model.log
            for t in range(nt):
                res = model(trait=trait0 + t)
                key = name if nt == 1 else f"{name}:trait{t}"
                summary[key] = {k: (v.tolist() if hasattr(v, "tolist")
                                    else v) for k, v in res.items()}
                summary[key]["runtime"] = time.time() - t_file
            model.log.output_file = os.path.join(args.output_dir,
                                                 name + ".txt")
            model.log._save_log()
            trait0 += nt
            print(f"{name}: done in {time.time() - t_file:.1f}s "
                  f"(group {gi + 1}/{len(groups)})", flush=True)

    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {args.output_dir}/summary.json ({len(summary)} traits)")
    return summary


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("-g", "--genotype", required=True)
    ap.add_argument("-annot", "--annotation", default=None)
    ap.add_argument("--pheno_glob", required=True)
    ap.add_argument("-c", "--covariate", default=None)
    ap.add_argument("-o", "--output_dir", default=None,
                    help="defaults to $RESULT_DIR/sweep_out (constant.py)")
    ap.add_argument("-k", "--num_vec", type=int, default=10)
    ap.add_argument("-jn", "--num_block", type=int, default=100)
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_merge", action="store_true",
                    help="one engine pass per file even when files share "
                         "a missing-individual set")
    return ap


def main():
    args = build_parser().parse_args()
    if args.output_dir is None:
        from pyrhe_tpu.constant import RESULT_DIR
        args.output_dir = os.path.join(RESULT_DIR, "sweep_out")
    run_sweep(args)


if __name__ == "__main__":
    main()
