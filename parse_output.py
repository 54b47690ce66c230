#!/usr/bin/env python
"""Regex-parse PyRHE-JAX (or reference PyRHE) output files into summary.json
(reference parse_output.py's role for the C++ RHE outputs)."""
from __future__ import annotations

import argparse
import json
import re


def parse_output_file(path: str) -> dict:
    with open(path) as f:
        content = f.read()
    res: dict = {}

    def pairs(pattern):
        return [{"value": float(a), "se": float(b)}
                for a, b in re.findall(pattern, content)]

    res["sigma2_g"] = pairs(r"Sigma\^2_g\[\d+\] : ([-\d.e]+)  SE : ([\d.e-]+)")
    res["sigma2_gxe"] = pairs(
        r"Sigma\^2_gxe\[\d+\] : ([-\d.e]+)  SE : ([\d.e-]+)")
    res["sigma2_nxe"] = pairs(
        r"Sigma\^2_nxe\[\d+\] : ([-\d.e]+)  SE : ([\d.e-]+)")
    m = re.search(r"Sigma\^2_e : ([-\d.e]+)  SE : ([\d.e-]+)", content)
    if m:
        res["sigma2_e"] = {"value": float(m.group(1)), "se": float(m.group(2))}
    res["h2_g"] = pairs(r"h2_g\[\d+\] : ([-\d.e]+) :? S?E? ?:? ?([\d.e-]+)")
    m = re.search(r"Total h2 : ([-\d.e]+) SE: ([\d.e-]+)", content)
    if m:
        res["total_h2"] = {"value": float(m.group(1)), "se": float(m.group(2))}
    res["enrichment_g"] = pairs(
        r"Enrichment g\[\d+\] : ([-\d.e]+) SE : ([\d.e-]+)")
    m = re.search(r"Runtime:  ([\d.]+)", content)
    if m:
        res["runtime"] = float(m.group(1))
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outputs", nargs="+", help="output files to parse")
    ap.add_argument("--json", default="summary.json")
    args = ap.parse_args()
    summary = {p: parse_output_file(p) for p in args.outputs}
    with open(args.json, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
