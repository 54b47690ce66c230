"""Engine end-to-end through the chunked packed-word scan (the
accelerator main path, run here on the CPU), compared against the
per-block natural-order engine path."""
import numpy as np
import pytest

from pyrhe_tpu.core.data import load_dataset
from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig


def run(ds, packed_scan, model="rhe", genie_model="G", env=False, J=4, B=4,
        impute="binary"):
    data = load_dataset(
        ds["prefix"], annot_file=ds["annot1_path"],
        pheno_file=ds["pheno_path"],
        env_file=ds["env_path"] if env else None,
        num_random_vec=B, seed=7)
    spec = ModelSpec.build(model, genie_model, data.num_env)
    cfg = RunConfig(num_random_vec=B, num_jack=J, seed=7,
                    geno_impute_method=impute, dtype="float32",
                    mm_mode="exact", packed_scan=packed_scan)
    eng = Engine(data, spec, cfg)
    eng.run_precompute_and_assemble()
    return eng


@pytest.mark.parametrize("model,genie_model,env", [
    ("rhe", "G", False),
    ("rhe_dom", "G", False),
    ("genie", "G+GxE+NxE", True),
])
def test_pallas_engine_matches_jnp(small_dataset, model, genie_model, env):
    eng_j = run(small_dataset, packed_scan=False, model=model,
                genie_model=genie_model, env=env)
    eng_p = run(small_dataset, packed_scan=True, model=model,
                genie_model=genie_model, env=env)
    assert eng_p.packed_scan and not eng_j.packed_scan
    np.testing.assert_allclose(eng_p.T_all, eng_j.T_all, rtol=5e-4,
                               atol=5e-3)
    np.testing.assert_allclose(eng_p.q_all, eng_j.q_all, rtol=5e-4,
                               atol=5e-3)
    sj_p, st_p = eng_p.estimate(0)
    sj_j, st_j = eng_j.estimate(0)
    np.testing.assert_allclose(st_p, st_j, rtol=2e-3, atol=2e-4)


def test_pallas_binary_impute_fills_match(small_dataset):
    """packed_col_stats-based fills must equal the decode-based fills."""
    eng_j = run(small_dataset, packed_scan=False)
    eng_p = run(small_dataset, packed_scan=True)
    for j in [0, 3]:
        _, fill_j, mode_j = eng_j._load_block(j)
        _, fill_p, mode_p = eng_p._load_block(j)
        assert mode_j == "host" and mode_p == "clean"
        m = len(fill_j)
        np.testing.assert_array_equal(fill_p[:m], fill_j)
        assert np.all(fill_p[m:] == 0)


@pytest.mark.parametrize("model,genie_model,env", [
    ("rhe", "G", False),
    ("rhe_dom", "G", False),   # masked g² moments feed the dom encoding
    ("genie", "G+GxE+NxE", True),
])
def test_pallas_engine_filtered_matches_jnp(filtered_dataset, model,
                                            genie_model, env):
    """Individual filtering (missing pheno rows) must run the word path
    too. Dropped individuals are zero-masked in the padded layout;
    parity vs the per-block path, which standardizes over the
    host-filtered matrix."""
    eng_j = run(filtered_dataset, packed_scan=False, model=model,
                genie_model=genie_model, env=env)
    eng_p = run(filtered_dataset, packed_scan=True, model=model,
                genie_model=genie_model, env=env)
    assert eng_p.packed_scan
    assert eng_p.data.bed.keep_idx is not None
    assert eng_p.data.num_indv == 600 - filtered_dataset["n_missing"]
    np.testing.assert_allclose(eng_p.T_all, eng_j.T_all, rtol=5e-4,
                               atol=5e-3)
    np.testing.assert_allclose(eng_p.q_all, eng_j.q_all, rtol=5e-4,
                               atol=5e-3)
    sj_p, st_p = eng_p.estimate(0)
    sj_j, st_j = eng_j.estimate(0)
    np.testing.assert_allclose(st_p, st_j, rtol=2e-3, atol=2e-4)


def test_pallas_filtered_fills_match(filtered_dataset):
    """Keep-corrected packed_col_stats must reproduce the decode-path
    fills bit-exactly under filtering (same HWE draws, same p)."""
    eng_j = run(filtered_dataset, packed_scan=False)
    eng_p = run(filtered_dataset, packed_scan=True)
    for j in [0, 3]:
        _, fill_j, mode_j = eng_j._load_block(j)
        _, fill_p, mode_p = eng_p._load_block(j)
        assert mode_j == "host" and mode_p == "clean"
        m = len(fill_j)
        np.testing.assert_array_equal(fill_p[:m], fill_j)


def test_hybrid_cache_matches_full_and_streaming(small_dataset,
                                                 monkeypatch):
    """Sequential chunked path with a partial stats cache
    (cfg.cache_blocks): cached chunks assemble from HBM, the rest is
    recomputed — bit-identical to both the fully-cached and the
    streaming runs (core/engine.py hybrid walk)."""
    from pyrhe_tpu.core.engine import Engine as Eng

    monkeypatch.setattr(Eng, "_chunk_size", lambda self: 1)

    def mk(**kw):
        ds = small_dataset
        data = load_dataset(ds["prefix"], annot_file=ds["annot1_path"],
                            pheno_file=ds["pheno_path"],
                            num_random_vec=4, seed=7)
        cfg = RunConfig(num_random_vec=4, num_jack=4, seed=7,
                        dtype="float32", mm_mode="exact",
                        packed_scan=True, **kw)
        eng = Engine(data, ModelSpec.build("rhe"), cfg)
        eng.run_precompute_and_assemble()
        return eng

    eng_full = mk()
    eng_h = mk(cache_blocks=2)
    eng_s = mk(streaming=True)
    assert eng_h.cache_limit == 2 and eng_full.cache_limit == 4
    np.testing.assert_array_equal(eng_h.T_all, eng_full.T_all)
    np.testing.assert_array_equal(eng_h.q_all, eng_full.q_all)
    np.testing.assert_array_equal(np.asarray(eng_s.T_all),
                                  np.asarray(eng_full.T_all))


def test_hybrid_zero_cache_equals_streaming_walk(small_dataset,
                                                 monkeypatch):
    """cache_blocks=0 without streaming: the walk recomputes every chunk
    in pass 2 — still bit-identical."""
    from pyrhe_tpu.core.engine import Engine as Eng

    monkeypatch.setattr(Eng, "_chunk_size", lambda self: 2)

    def mk(**kw):
        ds = small_dataset
        data = load_dataset(ds["prefix"], annot_file=ds["annot1_path"],
                            pheno_file=ds["pheno_path"],
                            num_random_vec=4, seed=7)
        cfg = RunConfig(num_random_vec=4, num_jack=4, seed=7,
                        dtype="float32", mm_mode="exact",
                        packed_scan=True, **kw)
        eng = Engine(data, ModelSpec.build("rhe"), cfg)
        eng.run_precompute_and_assemble()
        return eng

    eng_full = mk()
    eng_z = mk(cache_blocks=0)
    np.testing.assert_array_equal(eng_z.T_all, eng_full.T_all)
    np.testing.assert_array_equal(eng_z.q_all, eng_full.q_all)


def test_float64_pallas_falls_back_from_acc_path(small_dataset):
    """float64 working dtype runs the word path end to end (exact
    float64 dots on the decoded words, float64 scan carry) in streaming
    mode and matches the per-block float64 engine."""
    ds = small_dataset
    data = load_dataset(ds["prefix"], annot_file=ds["annot1_path"],
                        pheno_file=ds["pheno_path"], num_random_vec=4,
                        seed=7)
    cfg = RunConfig(num_random_vec=4, num_jack=4, seed=7, dtype="float64",
                    mm_mode="exact", packed_scan=True, streaming=True)
    eng = Engine(data, ModelSpec.build("rhe"), cfg)
    assert eng.packed_scan and eng.dtype == np.float64
    eng.run_precompute_and_assemble()

    ref = Engine(data, ModelSpec.build("rhe"),
                 RunConfig(num_random_vec=4, num_jack=4, seed=7,
                           dtype="float64"))
    ref.run_precompute_and_assemble()
    np.testing.assert_allclose(eng.T_all, ref.T_all, rtol=1e-10,
                               atol=1e-8)


def test_genie_gxe_acc_streaming_matches_cached(small_dataset,
                                                monkeypatch):
    """GENIE G+GxE+NxE on the word path: the streaming pass recomputes
    the GxE stats (env-scaled probe columns) in pass 2 and must stay
    BIT-identical to the cached run — per-block stats do not depend on
    which pass computes them."""
    from pyrhe_tpu.core.engine import Engine as Eng

    monkeypatch.setattr(Eng, "_chunk_size", lambda self: 2)
    ds = small_dataset

    def mk(streaming):
        data = load_dataset(ds["prefix"], annot_file=ds["annot8_path"],
                            pheno_file=ds["pheno_path"],
                            env_file=ds["env_path"],
                            num_random_vec=4, seed=7)
        spec = ModelSpec.build("genie", "G+GxE+NxE", data.num_env)
        cfg = RunConfig(num_random_vec=4, num_jack=4, seed=7,
                        dtype="float32", mm_mode="exact",
                        packed_scan=True, streaming=streaming)
        eng = Engine(data, spec, cfg)
        eng.run_precompute_and_assemble()
        return eng

    eng_c = mk(False)
    assert eng_c.packed_scan and len(eng_c.spec.components) == 2
    eng_s = mk(True)
    np.testing.assert_array_equal(eng_s.T_all, eng_c.T_all)
    np.testing.assert_array_equal(eng_s.q_all, eng_c.q_all)


def test_genie_multi_env_acc_streaming_matches_cached(small_dataset,
                                                      tmp_path,
                                                      monkeypatch):
    """num_env=2 GENIE G+GxE+NxE on the word path: THREE additive
    components (G + 2 GxE, each env column scaling its own probe
    variant) — the region where the reference's k_gxe indexing collides
    for num_env>1 (SURVEY 2.6); streaming must stay BIT-identical to the
    cached run."""
    from pyrhe_tpu.core.engine import Engine as Eng
    from pyrhe_tpu.io import synth

    monkeypatch.setattr(Eng, "_chunk_size", lambda self: 2)
    ds = small_dataset
    env2 = str(tmp_path / "two.env")
    synth.make_env_file(env2, 600, num_env=2, seed=13)

    def mk(streaming):
        data = load_dataset(ds["prefix"], annot_file=ds["annot1_path"],
                            pheno_file=ds["pheno_path"], env_file=env2,
                            num_random_vec=4, seed=7)
        assert data.num_env == 2
        spec = ModelSpec.build("genie", "G+GxE+NxE", data.num_env)
        cfg = RunConfig(num_random_vec=4, num_jack=4, seed=7,
                        dtype="float32", mm_mode="exact",
                        packed_scan=True, streaming=streaming)
        eng = Engine(data, spec, cfg)
        eng.run_precompute_and_assemble()
        return eng

    eng_c = mk(False)
    assert eng_c.packed_scan
    assert len(eng_c.spec.components) == 3
    eng_s = mk(True)
    np.testing.assert_array_equal(eng_s.T_all, eng_c.T_all)
    np.testing.assert_array_equal(eng_s.q_all, eng_c.q_all)


def test_rhe_dom_acc_streaming_matches_cached(small_dataset, monkeypatch):
    """RHE-DOM on the word path: the dominance component's g and g²
    contractions are recomputed in the streaming pass 2 — must stay
    BIT-identical to the cached run."""
    from pyrhe_tpu.core.engine import Engine as Eng

    monkeypatch.setattr(Eng, "_chunk_size", lambda self: 2)
    ds = small_dataset

    def mk(streaming):
        data = load_dataset(ds["prefix"], annot_file=ds["annot8_path"],
                            pheno_file=ds["pheno_path"],
                            num_random_vec=4, seed=7)
        cfg = RunConfig(num_random_vec=4, num_jack=4, seed=7,
                        dtype="float32", mm_mode="exact",
                        packed_scan=True, streaming=streaming)
        eng = Engine(data, ModelSpec.build("rhe_dom"), cfg)
        eng.run_precompute_and_assemble()
        return eng

    eng_c = mk(False)
    assert eng_c.packed_scan
    assert eng_c.spec.components == (("add", None), ("dom", None))
    eng_s = mk(True)
    np.testing.assert_array_equal(eng_s.T_all, eng_c.T_all)
    np.testing.assert_array_equal(eng_s.q_all, eng_c.q_all)
