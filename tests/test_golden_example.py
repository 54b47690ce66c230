"""Integration test mirroring the reference's test strategy (reference
pyrhe/test/integration_test/test_rhe.py): run the real CLI on the example
dataset via a config file, regex-parse the human-readable output, and
assert against committed golden values using SE-interval overlap.

The golden outputs in example/outputs/ were produced by the CPU float64
path (`example/make_example.py` + `--device cpu --dtype float64`); this
test regenerates the dataset (deterministic seeds) and checks one config
end-to-end, asserting |est - golden| <= SE_est + SE_golden like the
reference's is_within_range (test_rhe.py:154-163) plus a tight relative
check (same platform => near-exact).
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from parse_output import parse_output_file  # noqa: E402


@pytest.fixture(scope="module")
def example_dir(tmp_path_factory):
    """Synthesize the example dataset into a tempdir copy of example/."""
    import shutil

    d = tmp_path_factory.mktemp("example")
    for name in ("make_example.py", "test.sh"):
        shutil.copy(os.path.join(ROOT, "example", name), d)
    shutil.copytree(os.path.join(ROOT, "example", "configs"),
                    d / "configs")
    subprocess.run([sys.executable, str(d / "make_example.py")], check=True,
                   env=_env())
    return d


def _env():
    """Subprocess env: CPU backend, repo importable (PYTHONPATH appended,
    never clobbered)."""
    e = {**os.environ, "JAX_PLATFORMS": "cpu"}
    e["PYTHONPATH"] = ROOT + os.pathsep + e.get("PYTHONPATH", "")
    return e


def test_rhe_bin1_matches_golden(example_dir):
    golden = parse_output_file(os.path.join(
        ROOT, "example", "outputs", "rhe", "no_streaming_bin_1.txt"))
    out = example_dir / "out.txt"
    cfg = example_dir / "configs" / "rhe" / "no_streaming_bin_1.txt"
    text = cfg.read_text().replace(
        "output = outputs/rhe/no_streaming_bin_1.txt", f"output = {out}")
    cfg.write_text(text)
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "run_rhe.py"), "--config",
         str(cfg), "--device", "cpu", "--dtype", "float64", "--suppress"],
        check=True, cwd=example_dir, env=_env())
    got = parse_output_file(str(out))

    for key in ("sigma2_g", "h2_g", "enrichment_g"):
        assert len(got[key]) == len(golden[key]) >= 1, key
        for a, b in zip(got[key], golden[key]):
            # reference-style interval overlap ...
            assert abs(a["value"] - b["value"]) <= a["se"] + b["se"] + 1e-12
            # ... plus near-exact same-platform determinism
            assert abs(a["value"] - b["value"]) <= 1e-6 * max(
                1.0, abs(b["value"]))
    assert abs(got["sigma2_e"]["value"]
               - golden["sigma2_e"]["value"]) <= 1e-6
    assert abs(got["total_h2"]["value"]
               - golden["total_h2"]["value"]) <= 1e-6


# Ground truth measured by ACTUALLY RUNNING the reference implementation
# (/root/reference driven via scripts/_ref_compat/run_reference.py) on this
# exact dataset+seed — see docs/parity/REFERENCE_RUN.md. These values are
# independent of our code: the goldens above guard determinism, this
# guards correctness against the reference.
REFERENCE_RUN = {
    "sigma2_g0": (0.19463871297400007, 0.028870559402243593),
    "sigma2_e": (0.8097914438786151, 0.0288719996107502),
    "h2_g0": (0.19378023613299408, 0.028743496038605126),
}


def test_rhe_bin1_matches_reference_run(example_dir):
    out = example_dir / "out_ref_check.txt"
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "run_rhe.py"),
         "-g", "test", "-p", "test.pheno", "-annot", "single.annot",
         "-c", "test.cov", "-k", "10", "-jn", "100", "-s", "42",
         "-o", str(out), "--device", "cpu", "--dtype", "float64",
         "--suppress"],
        check=True, cwd=example_dir, env=_env())
    got = parse_output_file(str(out))
    checks = [
        (got["sigma2_g"][0], REFERENCE_RUN["sigma2_g0"]),
        (got["sigma2_e"], REFERENCE_RUN["sigma2_e"]),
        (got["h2_g"][0], REFERENCE_RUN["h2_g0"]),
    ]
    for ours, (ref_val, ref_se) in checks:
        # same probes (shared RNG discipline) => agreement far inside the
        # SE-overlap criterion; 1e-3 abs is ~100x the measured gap and
        # ~3% of the SE
        assert abs(ours["value"] - ref_val) <= 1e-3
        assert abs(ours["se"] - ref_se) <= 1e-3


# ---------------------------------------------------------------------------
# External anchoring: example/outputs/reference/ holds outputs produced by
# the ACTUAL reference implementation on this dataset (generated by
# scripts/make_reference_goldens.py through the _ref_compat shims; see the
# README there). Our committed goldens are pinned to them with the
# SE-interval overlap criterion the reference's own integration tests use
# (reference test_rhe.py:154-163) — so the golden chain is
# CLI == our golden (near-exact, tests above) ≈ reference golden.
REF_GOLD = os.path.join(ROOT, "example", "outputs", "reference")


def _reference_golden_pairs():
    out = []
    for model in ("rhe", "rhe_dom", "genie"):
        d = os.path.join(REF_GOLD, model)
        if os.path.isdir(d):
            for name in sorted(os.listdir(d)):
                if name.endswith(".txt") and os.path.exists(
                        os.path.join(ROOT, "example", "outputs", model,
                                     name)):
                    out.append((model, name))
    return out


@pytest.mark.parametrize("model,name", _reference_golden_pairs() or
                         [pytest.param(None, None, marks=pytest.mark.skip(
                             reason="no reference goldens generated"))])
def test_goldens_anchored_to_reference(model, name):
    ours = parse_output_file(os.path.join(ROOT, "example", "outputs",
                                          model, name))
    ref = parse_output_file(os.path.join(REF_GOLD, model, name))
    checked = 0
    for key in ("sigma2_g", "sigma2_gxe", "sigma2_nxe", "h2_g"):
        assert len(ours.get(key, [])) == len(ref.get(key, [])), key
        for a, b in zip(ours.get(key, []), ref.get(key, [])):
            assert abs(a["value"] - b["value"]) <= a["se"] + b["se"] + 1e-12, \
                (key, a, b)
            checked += 1
    if "sigma2_e" in ref:
        a, b = ours["sigma2_e"], ref["sigma2_e"]
        assert abs(a["value"] - b["value"]) <= a["se"] + b["se"] + 1e-12
        checked += 1
    assert checked >= 2, f"nothing parsed out of {model}/{name}"


# --------------------------------------------------------------------------
# Trace sumstat (.MN/.tr) format parity, anchored to files the REFERENCE
# actually wrote (reference base.py:831-855, generated by
# scripts/make_reference_goldens.py --trace pass): byte-format
# compatibility with SUMRHE consumers proven by diff, not construction.
TRACE_GOLD = os.path.join(REF_GOLD, "trace")


def _read_tr(path):
    with open(path) as f:
        header = f.readline().strip()
        rows = [line.strip().split(",") for line in f if line.strip()]
    vals = [[float(x) for x in r[:-1]] for r in rows]
    nsnps = [int(float(r[-1])) for r in rows]
    return header, vals, nsnps


def _trace_golden_cases():
    out = []
    for model in ("rhe", "rhe_dom", "genie"):
        d = os.path.join(TRACE_GOLD, model)
        if os.path.isdir(d):
            out.extend((model, name) for name in sorted(os.listdir(d)))
    return out


def _run_cli_with_trace(example_dir, model, cfg_name):
    cfg = example_dir / "configs" / model / f"{cfg_name}.txt"
    out = example_dir / f"trace_{model}_{cfg_name}.txt"
    tdir = example_dir / f"trace_{model}_{cfg_name}"
    os.makedirs(tdir, exist_ok=True)
    text = cfg.read_text().replace(
        f"output = outputs/{model}/{cfg_name}.txt",
        f"output = {out}").replace("trace = no", "trace = yes")
    cfg.write_text(text)
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "run_rhe.py"), "--config",
         str(cfg), "--trace_dir", str(tdir), "--device", "cpu",
         "--dtype", "float64", "--suppress"],
        check=True, cwd=example_dir, env=_env())
    return tdir


@pytest.mark.parametrize("model,cfg_name", _trace_golden_cases() or
                         [pytest.param(None, None, marks=pytest.mark.skip(
                             reason="no reference trace goldens"))])
def test_trace_matches_reference_format(example_dir, model, cfg_name):
    """Trace (.MN/.tr) sumstats anchored to files the REFERENCE wrote for
    every model/mode it can run (reference base.py:831-855,
    base_streaming.py:168-169). Format identity is exact; values match
    tightly for non-streaming runs, and loosely for the reference's
    streaming runs, whose pass-1 workers consume imputation RNG in a
    different order than its own non-streaming mode (ours is
    mode-invariant, pinned separately below)."""
    ref_dir = os.path.join(TRACE_GOLD, model, cfg_name)
    tdir = _run_cli_with_trace(example_dir, model, cfg_name)

    # .MN: byte-identical
    ref_mn = open(os.path.join(ref_dir, "run_test.pheno.MN")).read()
    got_mn = (tdir / "run_test.pheno.MN").read_text()
    assert got_mn == ref_mn

    # .tr: header byte-identical; jackknife SNP counts exact; LD sums
    # within the f32-vs-f64 numeric gap (measured ~3e-5 relative) for
    # non-streaming, within the reference's own streaming-vs-not RNG gap
    # (measured ~5%) for streaming
    ref_h, ref_v, ref_n = _read_tr(os.path.join(ref_dir,
                                                "run_test.pheno.tr"))
    got_h, got_v, got_n = _read_tr(str(tdir / "run_test.pheno.tr"))
    assert got_h == ref_h
    assert got_n == ref_n
    assert len(got_v) == len(ref_v)
    import numpy as np
    streaming = cfg_name.startswith("streaming")
    np.testing.assert_allclose(
        np.array(got_v), np.array(ref_v),
        rtol=(0.12 if streaming else 2e-3), atol=(30.0 if streaming
                                                  else 0.5))


def test_trace_mode_invariant(example_dir):
    """Our streaming .tr must be bit-identical to our non-streaming .tr
    (per-block stats do not depend on which pass computes them) — the
    substitute anchor where the reference's streaming trace numbers
    drift from its own non-streaming mode."""
    t_ns = _run_cli_with_trace(example_dir, "rhe", "no_streaming_bin_8")
    t_st = _run_cli_with_trace(example_dir, "rhe", "streaming_bin_8")
    ns = (t_ns / "run_test.pheno.tr").read_text()
    st = (t_st / "run_test.pheno.tr").read_text()
    assert ns == st
    assert (t_ns / "run_test.pheno.MN").read_text() == \
        (t_st / "run_test.pheno.MN").read_text()
