#!/usr/bin/env python
"""Run PyRHE-JAX and the reference implementation side by side on the same
data and compare estimates (the role of the reference's run_original.py,
which shells out to the C++ RHEmc/RHEmc_mem binaries and times them).

The comparator is located by (in order):
  1. --reference_cmd  (full command template; '{config}' is substituted)
  2. $RHEMC_BIN       (C++ RHE-mc binary)
  3. $PYRHE_DIR/run_rhe.py  (reference Python PyRHE checkout, needs its
     deps installed)
If none is available the script still runs and reports our side only.

Usage:
    python scripts/run_reference_compare.py --config example/configs/rhe/no_streaming_bin_1.txt
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from parse_output import parse_output_file  # noqa: E402


def run(cmd: list[str], cwd: str | None = None) -> float:
    t0 = time.time()
    subprocess.run(cmd, check=True, cwd=cwd)
    return time.time() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="INI config file")
    ap.add_argument("--reference_cmd", default=None,
                    help="command template, '{config}' substituted")
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as tmp:
        ours_out = os.path.join(tmp, "ours.txt")
        # the config's own `output=` key would override -o (config-overlay
        # precedence, reference behavior) — rewrite it like the reference's
        # integration tests do (test_rhe.py:175-182)
        cfg_copy = os.path.join(tmp, os.path.basename(args.config))
        with open(args.config) as f, open(cfg_copy, "w") as g:
            for line in f:
                if line.strip().startswith("output"):
                    line = f"output = {ours_out}\n"
                g.write(line)
        t_ours = min(run([sys.executable, os.path.join(ROOT, "run_rhe.py"),
                          "--config", cfg_copy])
                     for _ in range(args.reps))
        ours = parse_output_file(ours_out)
        ours["runtime_wall"] = t_ours

        ref = None
        ref_cmd = None
        pyrhe_dir = os.environ.get("PYRHE_DIR", "/root/reference")
        if args.reference_cmd:
            ref_cmd = shlex.split(args.reference_cmd.format(
                config=args.config))
        elif os.environ.get("RHEMC_BIN"):
            ref_cmd = [os.environ["RHEMC_BIN"], "--config", args.config]
        elif os.path.isdir(pyrhe_dir):
            # drive the reference's model classes through the compat
            # driver (its own CLI crashes on a string seed — SURVEY 2.6);
            # translate the INI config into driver flags
            from pyrhe_tpu.cli import parse_config
            cfgd = parse_config(args.config, "PyRHE_Config")
            ref_cmd = [sys.executable,
                       os.path.join(HERE, "_ref_compat",
                                    "run_reference.py")]
            flagmap = {"model": "--model", "genie_model": "--genie_model",
                       "genotype": "-g", "phenotype": "-p",
                       "covariate": "-c", "env": "-e",
                       "annotation": "-annot", "num_vec": "-k",
                       "num_bin": "-b", "num_block": "-jn", "seed": "-s"}
            for key, flag in flagmap.items():
                if cfgd.get(key) not in (None, "", "none", "None"):
                    ref_cmd += [flag, str(cfgd[key])]
            if cfgd.get("streaming", "no").lower() in ("yes", "true", "1"):
                ref_cmd.append("--streaming")
        if ref_cmd:
            ref_out = os.path.join(tmp, "ref.txt")
            t_ref = min(run(ref_cmd + ["-o", ref_out])
                        for _ in range(args.reps))
            ref = parse_output_file(ref_out)
            ref["runtime_wall"] = t_ref

    report = {"ours": ours, "reference": ref}
    if ref:
        for key in ("sigma2_g", "h2_g"):
            for i, (a, b) in enumerate(zip(ours.get(key, []),
                                           ref.get(key, []))):
                within = abs(a["value"] - b["value"]) <= a["se"] + b["se"]
                report.setdefault("within_se", {})[f"{key}[{i}]"] = within
        report["speedup"] = ref["runtime_wall"] / ours["runtime_wall"]
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
