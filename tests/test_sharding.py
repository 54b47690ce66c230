"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Validates that the shard_map path (blocks sharded over the 'jack' axis,
totals merged by psum) reproduces the sequential engine exactly.
"""
import jax
import numpy as np
import pytest

from pyrhe_tpu.core.data import load_dataset
from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig
from pyrhe_tpu.parallel.mesh import make_mesh


def _engines(ds, model="rhe", genie_model="G", cov=False, env=False,
             J=8, B=8, impute="binary"):
    def mk():
        data = load_dataset(
            ds["prefix"], annot_file=ds["annot1_path"],
            pheno_file=ds["pheno_path"],
            cov_file=ds["cov_path"] if cov else None,
            env_file=ds["env_path"] if env else None,
            num_random_vec=B, seed=7)
        spec = ModelSpec.build(model, genie_model, data.num_env)
        cfg = RunConfig(num_random_vec=B, num_jack=J, seed=7,
                        geno_impute_method=impute, dtype="float64")
        return Engine(data, spec, cfg)
    return mk


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_sharded_matches_sequential(small_dataset, n_dev):
    mk = _engines(small_dataset, cov=True)
    eng_seq = mk()
    eng_seq.run_precompute_and_assemble()
    eng_sh = mk()
    eng_sh.run_sharded(make_mesh(n_dev))
    np.testing.assert_allclose(eng_sh.T_all, eng_seq.T_all,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(eng_sh.q_all, eng_seq.q_all,
                               rtol=1e-10, atol=1e-10)


def test_sharded_genie(small_dataset):
    mk = _engines(small_dataset, model="genie", genie_model="G+GxE+NxE",
                  cov=True, env=True)
    eng_seq = mk()
    eng_seq.run_precompute_and_assemble()
    eng_sh = mk()
    eng_sh.run_sharded(make_mesh(8))
    np.testing.assert_allclose(eng_sh.T_all, eng_seq.T_all,
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(eng_sh.q_all, eng_seq.q_all,
                               rtol=1e-9, atol=1e-9)


def test_sharded_uneven_last_block(small_dataset, tmp_path):
    # M=800, J=6 -> last block bigger; sharded path pads to uniform m
    mk = _engines(small_dataset, J=6)
    eng_seq = mk()
    eng_seq.run_precompute_and_assemble()
    eng_sh = mk()
    eng_sh.run_sharded(make_mesh(2))
    np.testing.assert_allclose(eng_sh.T_all, eng_seq.T_all,
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("J,n_dev", [(10, 8), (7, 4), (3, 8)])
def test_sharded_any_jack_count(small_dataset, J, n_dev):
    """J need not divide the device count (the jack axis is padded with
    zero blocks); J < D leaves whole devices idle but correct."""
    mk = _engines(small_dataset, cov=True, J=J)
    eng_seq = mk()
    eng_seq.run_precompute_and_assemble()
    eng_sh = mk()
    eng_sh.run_sharded(make_mesh(n_dev))
    np.testing.assert_allclose(eng_sh.T_all, eng_seq.T_all,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(eng_sh.q_all, eng_seq.q_all,
                               rtol=1e-10, atol=1e-10)


def test_sharded_streaming_matches_cached(small_dataset):
    """Streaming (recompute) pass 2 under sharding is bit-identical to the
    cached pass 2 and to the sequential engine."""
    mk = _engines(small_dataset, cov=True, J=10)
    eng_seq = mk()
    eng_seq.run_precompute_and_assemble()
    eng_c = mk()
    eng_c.run_sharded(make_mesh(4))
    eng_s = mk()
    eng_s.cfg.streaming = True
    eng_s.run_sharded(make_mesh(4))
    np.testing.assert_allclose(eng_s.T_all, eng_c.T_all, rtol=0, atol=0)
    np.testing.assert_allclose(eng_s.q_all, eng_c.q_all, rtol=0, atol=0)
    np.testing.assert_allclose(eng_s.T_all, eng_seq.T_all,
                               rtol=1e-10, atol=1e-10)


def test_sharded_genie_streaming(small_dataset):
    mk = _engines(small_dataset, model="genie", genie_model="G+GxE+NxE",
                  cov=True, env=True, J=10)
    eng_seq = mk()
    eng_seq.run_precompute_and_assemble()
    eng_s = mk()
    eng_s.cfg.streaming = True
    eng_s.run_sharded(make_mesh(8))
    np.testing.assert_allclose(eng_s.T_all, eng_seq.T_all,
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(eng_s.q_all, eng_seq.q_all,
                               rtol=1e-9, atol=1e-9)


def test_sharded_pallas_interpret(small_dataset):
    """The packed-word scan under shard_map: the sharded hot path a
    multi-card host takes. float32 + split2 like the accelerator
    default; compared to the per-block float32 path at f32 tolerance."""
    import jax.numpy as jnp

    from pyrhe_tpu.core.data import load_dataset
    from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig

    ds = small_dataset

    def mk(packed_scan):
        data = load_dataset(ds["prefix"], annot_file=ds["annot1_path"],
                            pheno_file=ds["pheno_path"],
                            num_random_vec=4, seed=7)
        cfg = RunConfig(num_random_vec=4, num_jack=4, seed=7,
                        geno_impute_method="mean", dtype="float32",
                        packed_scan=packed_scan)
        return Engine(data, ModelSpec.build("rhe"), cfg)

    eng_ref = mk(False)
    eng_ref.run_precompute_and_assemble()
    eng_pl = mk(True)
    assert eng_pl.packed_scan and eng_pl.dtype == jnp.float32
    eng_pl.run_sharded(make_mesh(2))
    np.testing.assert_allclose(eng_pl.T_all, eng_ref.T_all,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(eng_pl.q_all, eng_ref.q_all,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("model,genie_model,env", [
    ("rhe", "G", False),
    ("genie", "G+GxE+NxE", True),     # env-scaled probe variants
    ("rhe_dom", "G", False),          # dominance: g and g² contractions
])
def test_sharded_pallas_streaming_acc_matches_cached(small_dataset,
                                                     monkeypatch, model,
                                                     genie_model, env):
    """Sharded streaming on the word path (ShardedRunner._scan_stats
    keep=False in pass 1, recomputed stats in pass 2) — including the GxE
    env plumbing and the dominance contractions through shard_map; it
    must stay BIT-identical to the fully-cached sharded run."""
    from pyrhe_tpu.core.data import load_dataset
    from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig

    ds = small_dataset

    def mk(streaming):
        data = load_dataset(ds["prefix"], annot_file=ds["annot8_path"],
                            pheno_file=ds["pheno_path"],
                            env_file=ds["env_path"] if env else None,
                            num_random_vec=4, seed=7)
        cfg = RunConfig(num_random_vec=4, num_jack=4, seed=7,
                        geno_impute_method="binary", dtype="float32",
                        mm_mode="exact", packed_scan=True,
                        streaming=streaming)
        return Engine(data, ModelSpec.build(model, genie_model,
                                            data.num_env), cfg)

    eng_c = mk(False)
    assert eng_c.packed_scan
    eng_c.run_sharded(make_mesh(2))
    eng_s = mk(True)
    eng_s.run_sharded(make_mesh(2))
    np.testing.assert_array_equal(eng_s.T_all, eng_c.T_all)
    np.testing.assert_array_equal(eng_s.q_all, eng_c.q_all)


def test_sharded_pallas_filtered(filtered_dataset):
    """Filtered individuals (missing pheno rows -> keep_idx) on the
    sharded word path: staging stays packed/cleaned and the mask
    zero-weights dropped rows — parity vs the sequential jnp engine on
    the host-filtered matrix."""
    from pyrhe_tpu.core.data import load_dataset
    from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig

    ds = filtered_dataset

    def mk(packed_scan):
        data = load_dataset(ds["prefix"], annot_file=ds["annot1_path"],
                            pheno_file=ds["pheno_path"],
                            num_random_vec=4, seed=7)
        cfg = RunConfig(num_random_vec=4, num_jack=4, seed=7,
                        geno_impute_method="binary", dtype="float32",
                        mm_mode="exact", packed_scan=packed_scan)
        return Engine(data, ModelSpec.build("rhe"), cfg)

    eng_ref = mk(False)
    eng_ref.run_precompute_and_assemble()
    eng_pl = mk(True)
    assert eng_pl.packed_scan and eng_pl.data.bed.keep_idx is not None
    eng_pl.run_sharded(make_mesh(2))
    np.testing.assert_allclose(eng_pl.T_all, eng_ref.T_all,
                               rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(eng_pl.q_all, eng_ref.q_all,
                               rtol=5e-4, atol=5e-3)


# ------------------------------------------------------------ checkpointing
def _ck_engines(ds, ck=None, streaming=False, J=6, B=4):
    def mk():
        data = load_dataset(ds["prefix"], annot_file=ds["annot1_path"],
                            pheno_file=ds["pheno_path"],
                            cov_file=ds["cov_path"], num_random_vec=B,
                            seed=7)
        spec = ModelSpec.build("rhe", "G", data.num_env)
        cfg = RunConfig(num_random_vec=B, num_jack=J, seed=7,
                        geno_impute_method="binary", dtype="float64",
                        streaming=streaming, checkpoint_dir=ck)
        return Engine(data, spec, cfg)
    return mk


def _multi_superstep_plan(monkeypatch):
    """Force C=1 so the plan has one superstep per owned block (the tiny
    test data otherwise fits one superstep and nothing would be crashed
    mid-run)."""
    from pyrhe_tpu.parallel.sharded import ShardedRunner, _Plan

    orig = ShardedRunner._make_plan

    def tiny(self):
        pl = orig(self)
        return _Plan(D=pl.D, C=1, S=pl.J_loc, J_loc=pl.J_loc,
                     J_pad=pl.J_pad, m_pad=pl.m_pad, W=pl.W)

    monkeypatch.setattr(ShardedRunner, "_make_plan", tiny)


def _crash_after_commits(monkeypatch, n_allowed):
    from pyrhe_tpu.core.checkpoint import Checkpoint

    real = Checkpoint.commit
    seen = {"n": 0}

    def crasher(self, phase, next_j):
        if seen["n"] >= n_allowed:
            raise RuntimeError("simulated crash")
        seen["n"] += 1
        real(self, phase, next_j)

    monkeypatch.setattr(Checkpoint, "commit", crasher)


def _spy_staging(monkeypatch):
    from pyrhe_tpu.parallel.sharded import ShardedRunner

    staged = []
    orig = ShardedRunner._stage_superstep

    def spy(self, s, np_dt):
        staged.append(s)
        return orig(self, s, np_dt)

    monkeypatch.setattr(ShardedRunner, "_stage_superstep", spy)
    return staged


@pytest.mark.parametrize("streaming", [False, True])
def test_sharded_kill_resume_mid_pass1(small_dataset, tmp_path,
                                       monkeypatch, streaming):
    """Kill after 2 committed supersteps of pass 1 on a multi-device mesh;
    the resumed run must skip them and reproduce the uninterrupted run
    bit-exactly."""
    _multi_superstep_plan(monkeypatch)
    ck = str(tmp_path / "ck")
    mk_plain = _ck_engines(small_dataset, streaming=streaming)
    base = mk_plain()
    base.run_sharded(make_mesh(2))   # J=6 on 2 devices -> S=3 supersteps

    mk = _ck_engines(small_dataset, ck, streaming=streaming)
    with monkeypatch.context() as m:
        _crash_after_commits(m, 2)
        with pytest.raises(RuntimeError, match="simulated crash"):
            mk().run_sharded(make_mesh(2))

    staged = _spy_staging(monkeypatch)
    eng2 = mk()
    eng2.run_sharded(make_mesh(2))
    # the s=2 COMMIT crashed after its totals (covering supersteps 0..2)
    # were saved: self-describing totals let pass 1 resume skip everything
    if streaming:   # only pass 2 re-stages (it recomputes all supersteps)
        assert sorted(staged) == [0, 1, 2], staged
    else:           # cached: pass 1 skipped, pass 2 reads the slab cache
        assert staged == [], staged
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)


@pytest.mark.parametrize("streaming", [False, True])
def test_sharded_kill_resume_mid_pass2(small_dataset, tmp_path,
                                       monkeypatch, streaming):
    """Kill during pass 2 (after 1 assembled superstep was committed);
    resume must rebuild only the remaining supersteps, bit-exactly."""
    _multi_superstep_plan(monkeypatch)
    ck = str(tmp_path / "ck")
    base = _ck_engines(small_dataset, streaming=streaming)()
    base.run_sharded(make_mesh(2))

    mk = _ck_engines(small_dataset, ck, streaming=streaming)
    # pass 1: 3 superstep commits + ("assemble", 0); crash at the commit
    # AFTER the first assembled superstep's slab was saved
    with monkeypatch.context() as m:
        _crash_after_commits(m, 4)
        with pytest.raises(RuntimeError, match="simulated crash"):
            mk().run_sharded(make_mesh(2))

    staged = _spy_staging(monkeypatch)
    eng2 = mk()
    eng2.run_sharded(make_mesh(2))
    if streaming:   # pass 2 re-stages only supersteps >= 1
        assert staged and min(staged) >= 1, staged
    else:           # cached: nothing is ever re-staged on resume
        assert staged == [], staged
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)


def test_sharded_done_resume(small_dataset, tmp_path):
    ck = str(tmp_path / "ck")
    mk = _ck_engines(small_dataset, ck)
    eng = mk()
    eng.run_sharded(make_mesh(2))
    eng2 = mk()

    def boom(*a, **kw):
        raise AssertionError("done-state resume must not restage anything")

    eng2._load_block = boom
    eng2.run_sharded(make_mesh(2))
    np.testing.assert_array_equal(eng2.T_all, eng.T_all)
    np.testing.assert_array_equal(eng2.q_all, eng.q_all)


def test_sharded_streaming_host_cache(small_dataset, monkeypatch):
    """The host-RAM packed cache on the sharded path: pass 2 restages this
    process's slots from memory (host_cache_hits recorded), bit-identical
    to the cache-off sharded run."""
    from pyrhe_tpu.core.data import load_dataset
    from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig

    def mk(cache_gb):
        data = load_dataset(small_dataset["prefix"],
                            annot_file=small_dataset["annot1_path"],
                            pheno_file=small_dataset["pheno_path"],
                            num_random_vec=4, seed=7)
        spec = ModelSpec.build("rhe", "G", data.num_env)
        cfg = RunConfig(num_random_vec=4, num_jack=6, seed=7,
                        dtype="float64", streaming=True,
                        host_cache_gb=cache_gb)
        return Engine(data, spec, cfg)

    off = mk(0)
    off.run_sharded(make_mesh(2))
    on = mk(-1)
    assert on._packed_cache is not None
    on.run_sharded(make_mesh(2))
    assert on.phase_times.get("host_cache_hits", 0) > 0
    np.testing.assert_array_equal(on.T_all, off.T_all)
    np.testing.assert_array_equal(on.q_all, off.q_all)


def test_sharded_hybrid_matches_cached(small_dataset, monkeypatch):
    """cache_blocks strictly between 0 and J_loc: leading supersteps
    assemble from the HBM cache, the tail is recomputed from re-staged
    bytes — bit-identical to the fully-cached run (parallel/sharded.py
    hybrid walk), with pass 2 restaging ONLY the unkept tail."""
    _multi_superstep_plan(monkeypatch)
    mk = _engines(small_dataset, cov=True, J=6)
    eng_c = mk()
    eng_c.run_sharded(make_mesh(2))            # J_loc=3, S=3 (C=1)
    staged = _spy_staging(monkeypatch)
    eng_h = mk()
    eng_h.cfg.cache_blocks = 2                 # cache 2/3 supersteps
    eng_h.run_sharded(make_mesh(2))
    # pass 1 stages all supersteps; pass 2 restages only the unkept s=2
    assert staged == [0, 1, 2, 2], staged
    np.testing.assert_array_equal(eng_h.T_all, eng_c.T_all)
    np.testing.assert_array_equal(eng_h.q_all, eng_c.q_all)


def test_sharded_kill_resume_hybrid(small_dataset, tmp_path, monkeypatch):
    """Kill a hybrid (partial-cache) sharded run mid-pass-1; the resumed
    run reloads the cached slab prefix (load_chunks_prefix), recomputes
    the unkept tail, and reproduces the uninterrupted run bit-exactly."""
    _multi_superstep_plan(monkeypatch)
    ck = str(tmp_path / "ck")
    mk_plain = _ck_engines(small_dataset)
    base = mk_plain()
    base.cfg.cache_blocks = 1                  # s_keep=1 of S=3
    base.run_sharded(make_mesh(2))

    mk = _ck_engines(small_dataset, ck)
    with monkeypatch.context() as m:
        _crash_after_commits(m, 2)
        eng = mk()
        eng.cfg.cache_blocks = 1
        with pytest.raises(RuntimeError, match="simulated crash"):
            eng.run_sharded(make_mesh(2))
    eng2 = mk()
    eng2.cfg.cache_blocks = 1
    eng2.run_sharded(make_mesh(2))
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)
