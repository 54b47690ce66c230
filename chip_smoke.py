#!/usr/bin/env python
"""Smoke run of pyrhe_tpu on one NVIDIA GPU: the quickest proof that the
system starts on the card and gives the right answers there.

    python chip_smoke.py            # phases 1-3 on one GPU
    python chip_smoke.py --four     # phase 4 alone, on four GPUs

Phases (the repo has no hand-written kernel, so there is no kernel phase:
every device operation is what XLA compiles from ops/moments.py):
  1 device   the card (nvidia-smi name and power limit), JAX's devices and
             version, whether the native .bed decoder loaded, and the
             compile-cache directory. Exits non-zero unless JAX's first
             device is a GPU.
  3 main     a synthetic biobank-scale dataset (N=100,000 x M=100,000,
             8 annotation bins, 4 covariates, 1 environment, 1% missing
             genotypes, a few NA phenotype rows) through run_rhe.py's
             entry point: RHE cached and streaming, RHE-DOM, and GENIE
             G+GxE+NxE with k=10, J=100; the split2 fast path against
             mm_mode="exact"; and the example dataset (N=5,000 x
             M=10,000) against the committed CPU float64 outputs.
  4 --four   one process drives four GPUs through the sharded runner on
             the main-phase RHE and GENIE data, compared with the
             sequential engine on the first GPU in the same process.

Tolerances (each with its reason):
  fast/exact    |dh2| <= 1e-4, SE within 1e-3 relative: split2 keeps
                ~1e-5 relative accuracy in the moment statistics
  cache modes   cached vs streaming within 1e-5 relative (or absolute
                below 1): the same per-block statistics, but XLA may
                compile the two scan bodies differently
  example       every estimate and SE within 2% of the CPU float64 SE:
                far inside the statistical noise the SE measures
  --four        sharded vs sequential within 1e-4 relative (or absolute
                below 1): per-card partial totals are summed in another
                order

Data goes to a temporary directory outside the checkout (TMPDIR), which
is removed at the end. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_MAIN, M_MAIN = 100_000, 100_000


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ phase 1
def phase_device(want: int):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (first device: {devs[0].platform})")
    check(len(devs) >= want, f"needs {want} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr[-500:]}")
    from pyrhe_tpu.io.bed import _load_native
    from pyrhe_tpu.utils.jaxcache import (cache_dir,
                                          enable_persistent_compilation_cache)
    enable_persistent_compilation_cache()
    for line in smi.stdout.strip().splitlines():
        log(line.strip())                  # card name, power limit
    log(f"jax {jax.__version__}: {devs}")
    log(f"native .bed decoder loaded: {_load_native() is not None}")
    log(f"compile cache: {cache_dir()}")
    return devs


# ------------------------------------------------------------------ phase 3
def make_main_data(work):
    from pyrhe_tpu.io import synth

    prefix = os.path.join(work, "big")
    t0 = time.time()
    synth.make_dataset_fast(prefix, N_MAIN, M_MAIN, [0.05] * 8, seed=1,
                            missing_rate=0.01)
    synth.make_cov_file(prefix + ".cov", N_MAIN, num_cov=4, seed=1)
    synth.make_env_file(prefix + ".env", N_MAIN, num_env=1, seed=1)
    with open(prefix + ".pheno") as f:
        lines = f.read().splitlines()
    for i in (1, 17, N_MAIN // 3, N_MAIN // 2, N_MAIN):   # body rows -> NA
        lines[i] = " ".join(lines[i].split()[:2] + ["NA"])
    with open(prefix + ".pheno", "w") as f:
        f.write("\n".join(lines) + "\n")
    log(f"main data: N={N_MAIN} M={M_MAIN} .bed "
        f"{os.path.getsize(prefix + '.bed') / 1e9:.2f} GB in "
        f"{time.time() - t0:.1f} s")
    return prefix


def main_argv(prefix):
    return ["-g", prefix, "-p", prefix + ".pheno", "-c", prefix + ".cov",
            "-annot", prefix + ".annot", "-k", "10", "-jn", "100",
            "--seed", "1", "--suppress"]


@contextlib.contextmanager
def env_var(key, value):
    old = os.environ.get(key)
    os.environ[key] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old


def run_cli(name, argv, out):
    """One run through run_rhe.py's entry point; returns the parsed
    report, after checking every estimate and SE is finite."""
    from parse_output import parse_output_file
    from pyrhe_tpu.cli import cli_entry

    t0 = time.time()
    cli_entry(argv + ["-o", out])
    wall = time.time() - t0
    res = parse_output_file(out)
    with open(out) as f:
        phases = [ln.split(":", 1)[1].strip() for ln in f
                  if ln.startswith("Phase times:")]
    log(f"{name}: wall {wall:.1f} s; phase times {phases[-1]}")
    vals = flat(res)
    check(vals and all(math.isfinite(v) for v in vals.values()),
          f"{name}: non-finite or missing estimates {vals}")
    check(res.get("total_h2"), f"{name}: no total h2 in the report")
    return res


def flat(res):
    """{name: value} over every estimate and SE of a parsed report."""
    out = {}
    for key, v in res.items():
        if isinstance(v, list):
            for i, e in enumerate(v):
                out[f"{key}[{i}]"] = e["value"]
                out[f"{key}[{i}].se"] = e["se"]
        elif isinstance(v, dict):
            out[key] = v["value"]
            out[f"{key}.se"] = v["se"]
    return out


def compare(name, a, b, rel, floor=1.0):
    """Every entry of a and b within rel * max(floor, |b|)."""
    fa, fb = flat(a), flat(b)
    check(fa.keys() == fb.keys(), f"{name}: reports differ in shape")
    worst = max(abs(fa[k] - fb[k]) / max(floor, abs(fb[k])) for k in fb)
    log(f"{name}: worst relative difference {worst:.3g} (limit {rel})")
    check(worst <= rel, f"{name}: {worst:.3g} > {rel}")


def exact_run(prefix):
    """The same RHE run with mm_mode='exact' (float32 HIGHEST dots)."""
    from pyrhe_tpu.models import RHE
    from pyrhe_tpu.utils.logger import Logger

    m = RHE(geno_file=prefix, annot_file=prefix + ".annot",
            pheno_file=prefix + ".pheno", cov_file=prefix + ".cov",
            num_jack=100, num_random_vec=10, seed=1,
            log=Logger(suppress=True, debug_mode=False))
    m.cfg = dataclasses.replace(m.cfg, mm_mode="exact")
    m._reset_engine()
    t0 = time.time()
    res = m(trait=0)
    log(f"rhe exact: wall {time.time() - t0:.1f} s")
    return res


def phase_main(work):
    prefix = make_main_data(work)
    base = main_argv(prefix)
    out = lambda n: os.path.join(work, n + ".txt")
    cached = run_cli("rhe cached", base, out("rhe"))
    streaming = run_cli("rhe streaming", base + ["--streaming"],
                        out("rhe_stream"))
    run_cli("rhe_dom", base + ["--model", "rhe_dom"], out("rhe_dom"))
    run_cli("genie G+GxE+NxE",
            base + ["--model", "genie", "--genie_model", "G+GxE+NxE",
                    "-e", prefix + ".env"], out("genie"))
    compare("rhe cached vs streaming", streaming, cached, 1e-5)

    ex = exact_run(prefix)
    K = len(ex["h2_total"]) - 1        # report lists non-overlapping first
    h2_fast = [e["value"] for e in cached["h2_g"][:K]] + [
        cached["total_h2"]["value"]]
    se_fast = [e["se"] for e in cached["h2_g"][:K]] + [
        cached["total_h2"]["se"]]
    d_h2 = max(abs(a - b) for a, b in zip(h2_fast, ex["h2_total"]))
    d_se = max(abs(a - b) / abs(b) for a, b in zip(se_fast, ex["h2_errs"]))
    log(f"split2 vs exact: max |dh2| {d_h2:.3g} (limit 1e-4), "
        f"max SE relative {d_se:.3g} (limit 1e-3)")
    check(d_h2 <= 1e-4 and d_se <= 1e-3, "split2 vs exact out of tolerance")
    phase_example(work)


def phase_example(work):
    """Example dataset on the GPU against the committed CPU float64
    outputs (example/outputs, written by the CPU float64 CLI run)."""
    import runpy

    from parse_output import parse_output_file

    ex = os.path.join(work, "example")
    os.makedirs(ex)
    shutil.copy(os.path.join(HERE, "example", "make_example.py"), ex)
    runpy.run_path(os.path.join(ex, "make_example.py"), run_name="__main__")
    for model, cfg in (("rhe", "no_streaming_bin_1"),
                       ("rhe_dom", "no_streaming_bin_8"),
                       ("genie", "no_streaming_bin_8")):
        with open(os.path.join(HERE, "example", "configs", model,
                               cfg + ".txt")) as f:
            text = f.read()
        got = os.path.join(ex, f"{model}_{cfg}.out")
        text = text.replace(f"output = outputs/{model}/{cfg}.txt",
                            f"output = {got}")
        path = os.path.join(ex, f"{model}_{cfg}.ini")
        with open(path, "w") as f:
            f.write(text)
        cwd = os.getcwd()
        os.chdir(ex)
        try:
            res = run_cli(f"example {model} {cfg}",
                          ["--config", path, "--suppress"], got)
        finally:
            os.chdir(cwd)
        gold = parse_output_file(os.path.join(HERE, "example", "outputs",
                                              model, cfg + ".txt"))
        fa, fb = flat(res), flat(gold)
        check(fa.keys() == fb.keys(), f"example {model}: report shape")
        worst, where = 0.0, None
        for k in fb:
            if k.endswith(".se"):
                continue
            se = max(fb[k + ".se"], 1e-4)   # SE 0: single-bin enrichment
            d = max(abs(fa[k] - fb[k]), abs(fa[k + ".se"] - fb[k + ".se"]))
            if d / se > worst:
                worst, where = d / se, k
        log(f"example {model} {cfg} vs CPU float64: worst difference "
            f"{worst:.3g} SE at {where} (limit 0.02)")
        check(worst <= 0.02, f"example {model} {cfg}: {worst:.3g} SE")


# ------------------------------------------------------------------ phase 4
def phase_four(work):
    prefix = make_main_data(work)
    base = main_argv(prefix)
    runs = (("rhe", []),
            ("genie", ["--model", "genie", "--genie_model", "G+GxE+NxE",
                       "-e", prefix + ".env"]))
    for name, extra in runs:
        with env_var("PYRHE_DISTRIBUTED", "0"):
            seq = run_cli(f"{name} sequential (1 GPU)", base + extra,
                          os.path.join(work, name + "_seq.txt"))
        shard = run_cli(f"{name} sharded (4 GPUs)", base + extra,
                        os.path.join(work, name + "_4.txt"))
        compare(f"{name} sharded vs sequential", shard, seq, 1e-4)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded phase")
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    try:
        import pyrhe_tpu  # noqa: F401
        import parse_output  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: FAIL: the program is not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    work = tempfile.mkdtemp(prefix="pyrhe_smoke_")
    try:
        devs = phase_device(4 if args.four else 1)
        if args.four:
            phase_four(work)
        else:
            phase_main(work)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
