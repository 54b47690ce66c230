"""Crash-safe checkpoint/resume (core/checkpoint.py + engine wiring).

Every test compares a resumed run bit-for-bit against an uncheckpointed
run of the same configuration: snapshots store exact host copies of the
accumulators and resumption replays the remaining blocks in the same
order, so no tolerance is needed. Crashes are simulated by raising from
the checkpoint's commit hook — commit is the last step of every save, so
this exercises the torn-state window the atomic protocol must survive.
"""
import os

import numpy as np
import pytest

from pyrhe_tpu.core.data import load_dataset
from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig


def make_engine(ds, ckpt_dir=None, streaming=False, packed_scan=False, J=8,
                B=4, dtype="float64", every=1, seed=7, cache_blocks=-1,
                model="rhe"):
    data = load_dataset(ds["prefix"], annot_file=ds["annot1_path"],
                        pheno_file=ds["pheno_path"], num_random_vec=B,
                        seed=seed)
    spec = ModelSpec.build(model, "G", data.num_env)
    cfg = RunConfig(num_random_vec=B, num_jack=J, seed=seed,
                    geno_impute_method="binary",
                    dtype=("float32" if packed_scan else dtype),
                    mm_mode=("exact" if packed_scan else "auto"),
                    streaming=streaming, packed_scan=packed_scan,
                    checkpoint_dir=ckpt_dir, checkpoint_every=every,
                    cache_blocks=cache_blocks)
    return Engine(data, spec, cfg)


def crash_commit_after(eng, n_allowed=None, phase_at=None):
    """Replace the engine checkpoint's commit with one that raises after
    n_allowed successful commits (or when a specific (phase, next_j)
    commit is attempted), leaving the last committed state intact."""
    real = eng._ckpt.commit
    seen = {"n": 0}

    def crasher(phase, next_j):
        if phase_at is not None and (phase, next_j) == phase_at:
            raise RuntimeError("simulated crash")
        if n_allowed is not None and seen["n"] >= n_allowed:
            raise RuntimeError("simulated crash")
        seen["n"] += 1
        real(phase, next_j)

    eng._ckpt.commit = crasher


def spy_loads(eng):
    loaded = []
    orig = eng._load_block

    def spy(j, raw=False):
        loaded.append(j)
        return orig(j, raw)

    eng._load_block = spy
    return loaded


def test_done_resume_reads_nothing(small_dataset, tmp_path):
    ck = str(tmp_path / "ck")
    base = make_engine(small_dataset)
    base.run_precompute_and_assemble()
    eng = make_engine(small_dataset, ck)
    eng.run_precompute_and_assemble()
    np.testing.assert_array_equal(eng.T_all, base.T_all)

    eng2 = make_engine(small_dataset, ck)

    def boom(j, raw=False):
        raise AssertionError("resume from phase done must not touch .bed")

    eng2._load_block = boom
    eng2.run_precompute_and_assemble()
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)
    sj2, st2 = eng2.estimate(0)
    sjb, stb = base.estimate(0)
    np.testing.assert_array_equal(st2, stb)
    np.testing.assert_array_equal(sj2, sjb)


def test_crash_mid_precompute_blocks_path(small_dataset, tmp_path):
    ck = str(tmp_path / "ck")
    base = make_engine(small_dataset)
    base.run_precompute_and_assemble()

    eng = make_engine(small_dataset, ck)
    crash_commit_after(eng, n_allowed=3)   # 3 block commits, then crash
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run_precompute_and_assemble()

    eng2 = make_engine(small_dataset, ck)
    loaded = spy_loads(eng2)
    eng2.run_precompute_and_assemble()
    # the crash hit the j=3 COMMIT, after totals.npz (covering 0..3) was
    # saved: the self-describing totals let resume skip block 3 too
    assert min(loaded) == 4, "blocks 0-3 were checkpointed, must be skipped"
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)


def test_crash_mid_assemble_streaming(small_dataset, tmp_path):
    ck = str(tmp_path / "ck")
    base = make_engine(small_dataset, streaming=True)
    base.run_precompute_and_assemble()

    eng = make_engine(small_dataset, ck, streaming=True)
    crash_commit_after(eng, phase_at=("assemble", 4))
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run_precompute_and_assemble()
    assert eng._ckpt.state() is not None  # partial assemble state on disk

    eng2 = make_engine(small_dataset, ck, streaming=True)
    loaded = spy_loads(eng2)
    eng2.run_precompute_and_assemble()
    # precompute totals were final: only assemble re-reads, from sample 4
    # on (assemble.npz covering 0..3 was saved before the crashing commit)
    assert min(loaded) == 4
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)


def test_fingerprint_mismatch_starts_fresh(small_dataset, tmp_path):
    ck = str(tmp_path / "ck")
    eng = make_engine(small_dataset, ck)
    eng.run_precompute_and_assemble()

    base8 = make_engine(small_dataset, seed=8)
    base8.run_precompute_and_assemble()
    eng2 = make_engine(small_dataset, ck, seed=8)   # different seed
    assert eng2._ckpt.state() is None, "stale checkpoint must be discarded"
    eng2.run_precompute_and_assemble()
    np.testing.assert_array_equal(eng2.T_all, base8.T_all)


def test_crash_mid_precompute_chunked_pallas(small_dataset, tmp_path,
                                             monkeypatch):
    ck = str(tmp_path / "ck")
    monkeypatch.setattr(Engine, "_chunk_size", lambda self: 2)
    base = make_engine(small_dataset, packed_scan=True, J=6)
    assert base.packed_scan
    base.run_precompute_and_assemble()

    eng = make_engine(small_dataset, ck, packed_scan=True, J=6)
    crash_commit_after(eng, n_allowed=1)   # first chunk committed, then die
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run_precompute_and_assemble()
    assert eng._ckpt.state() == ("precompute", 2)

    eng2 = make_engine(small_dataset, ck, packed_scan=True, J=6)
    loaded = spy_loads(eng2)
    eng2.run_precompute_and_assemble()
    # crash hit the second chunk's commit AFTER its data files were saved:
    # resume trusts the self-describing totals and skips chunks [0,4)
    assert min(loaded) == 4, "chunks [0,4) were checkpointed, must be skipped"
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)


def test_crash_mid_assemble_streaming_chunked(small_dataset, tmp_path,
                                              monkeypatch):
    ck = str(tmp_path / "ck")
    monkeypatch.setattr(Engine, "_chunk_size", lambda self: 2)
    base = make_engine(small_dataset, packed_scan=True, streaming=True, J=4)
    base.run_precompute_and_assemble()

    eng = make_engine(small_dataset, ck, packed_scan=True, streaming=True,
                      J=4)
    crash_commit_after(eng, phase_at=("assemble", 2))
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run_precompute_and_assemble()
    assert eng._ckpt.state() == ("assemble", 0)

    eng2 = make_engine(small_dataset, ck, packed_scan=True, streaming=True,
                       J=4)
    loaded = spy_loads(eng2)
    eng2.run_precompute_and_assemble()
    assert min(loaded) == 2
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)


def test_crash_mid_precompute_dom_acc(small_dataset, tmp_path,
                                      monkeypatch):
    """Kill/resume through RHE-DOM streaming on the word path (g and g²
    contractions, totals carried through the chunk scan and saved at
    checkpoint boundaries) — a resumed run must reproduce the
    uninterrupted run bit-exactly."""
    ck = str(tmp_path / "ck")
    monkeypatch.setattr(Engine, "_chunk_size", lambda self: 1)
    base = make_engine(small_dataset, packed_scan=True, streaming=True,
                       J=4, model="rhe_dom")
    assert base.packed_scan and base.cfg.streaming
    base.run_precompute_and_assemble()

    eng = make_engine(small_dataset, ck, packed_scan=True, streaming=True,
                      J=4, model="rhe_dom")
    crash_commit_after(eng, n_allowed=2)
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run_precompute_and_assemble()

    eng2 = make_engine(small_dataset, ck, packed_scan=True, streaming=True,
                       J=4, model="rhe_dom")
    eng2.run_precompute_and_assemble()
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)


def test_crash_mid_assemble_hybrid_chunked(small_dataset, tmp_path,
                                           monkeypatch):
    """The HYBRID (non-streaming, partial cache) pass 2 must checkpoint
    its progress like the streaming branch: a crash mid-walk resumes from
    the last saved sample instead of recomputing the whole pass."""
    ck = str(tmp_path / "ck")
    monkeypatch.setattr(Engine, "_chunk_size", lambda self: 2)
    base = make_engine(small_dataset, packed_scan=True, J=6, cache_blocks=2)
    assert base.cache_limit == 2
    base.run_precompute_and_assemble()

    eng = make_engine(small_dataset, ck, packed_scan=True, J=6,
                      cache_blocks=2)
    crash_commit_after(eng, phase_at=("assemble", 4))
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run_precompute_and_assemble()

    eng2 = make_engine(small_dataset, ck, packed_scan=True, J=6,
                       cache_blocks=2)
    loaded = spy_loads(eng2)
    eng2.run_precompute_and_assemble()
    # assemble.npz covering samples [0, 4) was saved before the crashing
    # commit: only the hybrid tail [4, 6) may be restaged on resume
    assert min(loaded) == 4
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)


def test_cache_blocks_respected_on_blocks_path(small_dataset, tmp_path):
    """--cache_blocks gates the non-chunked (per-block) path too: beyond
    the budget nothing is cached and pass 2 recomputes via _loo_stats'
    cache-miss branch; a checkpoint resume tolerates the holes."""
    base = make_engine(small_dataset)          # full cache ground truth
    base.run_precompute_and_assemble()

    eng0 = make_engine(small_dataset, cache_blocks=0)
    assert not eng0.packed_scan                 # per-block path on CPU
    eng0.precompute()
    assert eng0._cache == {}, "cache_blocks=0 must cache nothing"
    eng0.assemble()
    np.testing.assert_array_equal(eng0.T_all, base.T_all)

    ck = str(tmp_path / "ck")
    eng = make_engine(small_dataset, ck, cache_blocks=3)
    crash_commit_after(eng, n_allowed=5)
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run_precompute_and_assemble()
    eng2 = make_engine(small_dataset, ck, cache_blocks=3)
    assert len(eng2._ckpt.load_blocks_partial(6)) == 3  # only the budget
    eng2.run_precompute_and_assemble()
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)


def test_pheno_change_invalidates_checkpoint(small_dataset, tmp_path):
    """simulate_pheno-style phenotype swaps (same shapes) must not reuse
    stale totals: the fingerprint hashes pheno/cov/env/annot content."""
    ck = str(tmp_path / "ck")
    data = load_dataset(small_dataset["prefix"],
                        annot_file=small_dataset["annot1_path"],
                        pheno_file=small_dataset["pheno_path"],
                        num_random_vec=4, seed=7)
    spec = ModelSpec.build("rhe", "G", data.num_env)
    cfg = RunConfig(num_random_vec=4, num_jack=8, seed=7, dtype="float64",
                    checkpoint_dir=ck)
    Engine(data, spec, cfg).run_precompute_and_assemble()

    data.pheno = data.pheno + 1.0    # content change, same shape
    eng2 = Engine(data, spec, cfg)
    assert eng2._ckpt.state() is None


def test_corrupt_block_file_recomputes_only_that_block(small_dataset,
                                                       tmp_path):
    """A truncated block cache file (partial directory copy, power loss)
    must neither crash the resume nor discard the totals: the corrupt
    entry is skipped on load and pass 2 recomputes exactly that block
    through _loo_stats' cache-miss branch."""
    ck = tmp_path / "ck"
    base = make_engine(small_dataset)
    base.run_precompute_and_assemble()

    eng = make_engine(small_dataset, str(ck))
    crash_commit_after(eng, n_allowed=5)
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run_precompute_and_assemble()
    # truncate a committed block file mid-byte (power-loss shape)
    victim = ck / "block_000002.npz"
    victim.write_bytes(victim.read_bytes()[:10])

    eng2 = make_engine(small_dataset, str(ck))
    loaded = spy_loads(eng2)
    eng2.run_precompute_and_assemble()
    # precompute resumes at 6 (totals are intact); the corrupt block 2 is
    # the only pre-crash block ever re-read, by the pass-2 cache miss
    assert sorted(set(loaded)) == [2, 6, 7]
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)


def test_corrupt_totals_starts_fresh(small_dataset, tmp_path):
    """Corrupt TOTALS are unusable state: resume must fall back to a
    fresh start (reset), not crash."""
    ck = tmp_path / "ck"
    base = make_engine(small_dataset)
    base.run_precompute_and_assemble()

    eng = make_engine(small_dataset, str(ck))
    crash_commit_after(eng, n_allowed=5)
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run_precompute_and_assemble()
    victim = ck / "totals.npz"
    victim.write_bytes(victim.read_bytes()[:10])

    eng2 = make_engine(small_dataset, str(ck))
    loaded = spy_loads(eng2)
    eng2.run_precompute_and_assemble()
    assert min(loaded) == 0, "corrupt totals must restart from block 0"
    np.testing.assert_array_equal(eng2.T_all, base.T_all)
    np.testing.assert_array_equal(eng2.q_all, base.q_all)


def test_corrupt_results_recomputes(small_dataset, tmp_path):
    ck = tmp_path / "ck"
    base = make_engine(small_dataset)
    base.run_precompute_and_assemble()
    eng = make_engine(small_dataset, str(ck))
    eng.run_precompute_and_assemble()
    (ck / "results.npz").write_bytes(b"not a zip")
    eng2 = make_engine(small_dataset, str(ck))
    eng2.run_precompute_and_assemble()
    np.testing.assert_array_equal(eng2.T_all, base.T_all)


def test_lock_excludes_other_processes(small_dataset, tmp_path):
    """Two live runs must not share one --checkpoint_dir: the second run
    proceeds WITHOUT checkpointing (and leaves the first's state alone)."""
    import subprocess
    import sys
    import time as _time

    ck = tmp_path / "ck"
    ck.mkdir()
    marker = ck / "meta.json"
    marker.write_text("{}")   # would be reset() fodder if the lock failed
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import fcntl,os,sys,time\n"
         f"fd=os.open({str(ck / '.lock')!r}, os.O_CREAT|os.O_RDWR)\n"
         "fcntl.flock(fd, fcntl.LOCK_EX)\n"
         "print('locked', flush=True)\n"
         "time.sleep(60)\n"])
    try:
        deadline = _time.time() + 20
        while not (ck / ".lock").exists() and _time.time() < deadline:
            _time.sleep(0.05)
        _time.sleep(0.3)   # let the child take the flock
        eng = make_engine(small_dataset, str(ck))
        assert eng._ckpt is None, "locked dir must disable checkpointing"
        eng.run_precompute_and_assemble()   # still runs fine
        assert marker.read_text() == "{}", "other run's state must survive"
    finally:
        holder.kill()
        holder.wait()


def test_bed_content_change_invalidates(small_dataset, tmp_path):
    """A regenerated .bed with identical size at the same path (same N, M)
    must invalidate the checkpoint — size alone is shape-determined."""
    import shutil

    prefix = str(tmp_path / "copy")
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(small_dataset["prefix"] + ext, prefix + ext)
    ds = dict(small_dataset, prefix=prefix)
    ck = str(tmp_path / "ck")
    make_engine(ds, ck).run_precompute_and_assemble()

    with open(prefix + ".bed", "r+b") as f:   # flip bytes mid-file
        f.seek(os.path.getsize(prefix + ".bed") // 2)
        f.write(bytes([0x55, 0xAA]))
    eng2 = make_engine(ds, ck)
    assert eng2._ckpt.state() is None, "stale genotypes must not resume"


def test_checkpoint_every_gates_stats_io(tmp_path):
    """--checkpoint_every throttles the dominant I/O: staged block/chunk
    saves hit disk only when the covering totals/commit is written."""
    from pyrhe_tpu.core.checkpoint import Checkpoint

    ck = Checkpoint(str(tmp_path), {"a": 1})
    for j in range(3):
        ck.stage_block(j, np.ones((2, 4)), np.ones((2, 1)))
    assert not list(tmp_path.glob("block_*.npz")), "stats writes not gated"
    ck.save_totals(np.zeros(3), np.zeros(3), 3)
    assert len(list(tmp_path.glob("block_*.npz"))) == 3
    ck.commit("precompute", 3)


def test_reset_cleans_own_tmp_files(tmp_path):
    from pyrhe_tpu.core.checkpoint import Checkpoint

    (tmp_path / "totals.npz.tmp").write_bytes(b"torn write")
    (tmp_path / "meta.json.tmp").write_text("torn")
    (tmp_path / "users_file.txt").write_text("keep me")   # not ours
    ck = Checkpoint(str(tmp_path), {"a": 1})
    ck.reset()
    assert not (tmp_path / "totals.npz.tmp").exists()
    assert not (tmp_path / "meta.json.tmp").exists()
    assert (tmp_path / "users_file.txt").exists()
