"""Phenotype-sweep driver (scripts/sweep_phenotypes.py): cross-file
amortization must not change any result.

The reference's test_real.py launches one process per UKBB phenotype (50
genome passes); our sweep merges files with identical missing-individual
sets into one multi-trait engine pass. These tests pin (a) the pass
count and (b) value identity against individually-run files.
"""
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from sweep_phenotypes import (build_parser, group_pheno_files,  # noqa: E402
                              run_sweep)


def _make_pheno_files(small_dataset, d):
    """a/b: complete phenotypes (mergeable); c: NA rows (own group)."""
    from pyrhe_tpu.io import synth

    a = os.path.join(d, "a.pheno")
    shutil.copy(small_dataset["pheno_path"], a)
    synth.simulate_pheno_file(os.path.join(d, "b"),
                              small_dataset["prefix"], [0.5],
                              small_dataset["annot1"], seed=21)
    with open(a) as f:
        lines = f.read().splitlines()
    c = os.path.join(d, "c.pheno")
    with open(c, "w") as f:
        for i, ln in enumerate(lines):
            if i in (5, 10):
                cols = ln.split()
                ln = " ".join(cols[:2] + ["NA"] * (len(cols) - 2))
            f.write(ln + "\n")
    return [a, os.path.join(d, "b.pheno"), c]


def test_sweep_reports_carry_engine_messages(small_dataset, tmp_path,
                                             monkeypatch):
    """Engine messages emitted during the (lazy) shared precompute must
    land in the per-file report: the sweep retargets the ENGINE's logger
    when it swaps in each file's fresh Logger — without that, cache-cap
    notes, streaming-switch notes and checkpoint-resume messages
    vanish from every saved .txt (round-5 review fix)."""
    from pyrhe_tpu.core.engine import Engine

    d = str(tmp_path / "phenos")
    os.makedirs(d)
    _make_pheno_files(small_dataset, d)

    orig = Engine.precompute

    def noisy(self):
        self.log._log("ENGINE-NOTE-MARKER")
        return orig(self)

    monkeypatch.setattr(Engine, "precompute", noisy)
    args = build_parser().parse_args([
        "-g", small_dataset["prefix"],
        "-annot", small_dataset["annot1_path"],
        "--pheno_glob", os.path.join(d, "*.pheno"),
        "-o", str(tmp_path / "out"), "-k", "4", "-jn", "4"])
    run_sweep(args)
    # one precompute per group, landing in the FIRST file's report:
    # group {a, b} -> a.txt, group {c} -> c.txt
    texts = {n: (tmp_path / "out" / f"{n}.txt").read_text()
             for n in ("a", "b", "c")}
    assert "ENGINE-NOTE-MARKER" in texts["a"]
    assert "ENGINE-NOTE-MARKER" in texts["c"]
    assert "ENGINE-NOTE-MARKER" not in texts["b"]


def test_grouping_by_missing_set(small_dataset, tmp_path):
    files = _make_pheno_files(small_dataset, str(tmp_path))
    groups = group_pheno_files(sorted(files))
    assert sorted(len(g) for g in groups) == [1, 2]
    merged = next(g for g in groups if len(g) == 2)
    assert {os.path.basename(p) for p in merged} == {"a.pheno", "b.pheno"}


def test_sweep_merges_and_matches_individual_runs(small_dataset, tmp_path,
                                                  monkeypatch):
    from pyrhe_tpu.core.engine import Engine

    d = str(tmp_path / "phenos")
    os.makedirs(d)
    _make_pheno_files(small_dataset, d)

    passes = []
    orig = Engine.precompute
    monkeypatch.setattr(Engine, "precompute",
                        lambda self: (passes.append(1), orig(self))[1])

    def sweep(outdir, extra=()):
        args = build_parser().parse_args([
            "-g", small_dataset["prefix"],
            "-annot", small_dataset["annot1_path"],
            "--pheno_glob", os.path.join(d, "*.pheno"),
            "-o", str(tmp_path / outdir), "-k", "4", "-jn", "4",
            *extra])
        return run_sweep(args)

    merged = sweep("merged")
    assert len(passes) == 2, \
        "a+b share one genome pass; c (different missing set) gets its own"
    assert set(merged) == {"a", "b", "c"}

    passes.clear()
    solo = sweep("solo", ["--no_merge"])
    assert len(passes) == 3
    for key in merged:
        for field in ("sigma_ests_total", "h2_total", "sig_errs"):
            np.testing.assert_allclose(
                merged[key][field], solo[key][field], rtol=1e-10,
                atol=1e-12, err_msg=f"{key}/{field}")

    # per-file reports written and parseable, one per input file
    from parse_output import parse_output_file
    for name in ("a", "b", "c"):
        res = parse_output_file(str(tmp_path / "merged" / f"{name}.txt"))
        assert res["sigma2_g"], name
        np.testing.assert_allclose(
            res["sigma2_g"][0]["value"],
            merged[name]["sigma_ests_total"][0], rtol=1e-9)
