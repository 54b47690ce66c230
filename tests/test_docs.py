"""API reference build: one command, current, covering the public
surfaces (the role of the reference's Sphinx docs/api tree, built
hermetically by scripts/build_api_docs.py)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
API = os.path.join(ROOT, "docs", "api")


def test_api_docs_build_clean_and_current():
    """The committed pages regenerate bit-identically (stale docs fail)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "build_api_docs.py"), "--check"],
        capture_output=True, text=True, env=env)
    assert res.returncode == 0, res.stdout + res.stderr


def test_api_docs_cover_required_surfaces():
    required = {
        "pyrhe_tpu_core_engine.md": ["class `Engine`", "class `RunConfig`",
                                     "class `ModelSpec`"],
        "pyrhe_tpu_core_checkpoint.md": ["class `Checkpoint`"],
        "pyrhe_tpu_core_solver.md": ["`jackknife_se", "`h2_overlapping"],
        "pyrhe_tpu_models_rhe.md": ["class `RHE`", "class `StreamingRHE`"],
        "pyrhe_tpu_models_rhe_dom.md": ["class `RHE_DOM`"],
        "pyrhe_tpu_models_genie.md": ["class `GENIE`",
                                      "class `StreamingGENIE`"],
        "pyrhe_tpu_ops_moments.md": ["block_stats"],
        "pyrhe_tpu_ops_decode.md": ["decode_packed_jnp"],
        "pyrhe_tpu_parallel_sharded.md": ["class `ShardedRunner`"],
        "pyrhe_tpu_io_bed.md": ["class `BedFile`"],
    }
    for fname, needles in required.items():
        text = open(os.path.join(API, fname)).read()
        for needle in needles:
            assert needle in text, (fname, needle)
    index = open(os.path.join(API, "index.md")).read()
    for fname in required:
        assert fname in index
