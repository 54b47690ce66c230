"""True multi-process (multi-host pattern) execution test: 2 CPU
processes x 2 devices under jax.distributed, gloo collectives across the
process boundary — the same program shape a multi-host run has. Each process
stages only the .bed blocks its own devices own; the result must equal
the sequential single-process engine exactly (float64)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(data_dir, tmp, streaming=False, ckpt=None,
                 want_logs=False, packed=False):
    port = _free_port()
    outs, procs = [], []
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    for pid in range(2):
        out = os.path.join(tmp, f"rank{pid}.npz")
        outs.append(out)
        cmd = [sys.executable, os.path.join(HERE, "_mh_worker.py"),
               str(pid), "2", str(port), data_dir, out]
        if streaming:
            cmd.append("streaming")
        if packed:
            cmd.append("packed")
        if ckpt:
            cmd.append(f"ckpt={ckpt}")
        procs.append(subprocess.Popen(cmd, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    arrays = [np.load(o) for o in outs]
    return (arrays, logs) if want_logs else arrays


@pytest.mark.parametrize("streaming", [False, True])
def test_two_process_matches_sequential(small_dataset, tmp_path, streaming):
    from pyrhe_tpu.core.data import load_dataset
    from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig

    ds = small_dataset
    data = load_dataset(ds["prefix"], annot_file=ds["annot1_path"],
                        pheno_file=ds["pheno_path"],
                        cov_file=ds["cov_path"], num_random_vec=8, seed=7)
    cfg = RunConfig(num_random_vec=8, num_jack=10, seed=7, dtype="float64",
                    geno_impute_method="binary")
    eng = Engine(data, ModelSpec.build("rhe"), cfg)
    eng.run_precompute_and_assemble()

    ranks = _run_workers(ds["dir"], str(tmp_path), streaming=streaming)
    for rank in ranks:
        np.testing.assert_allclose(rank["T_all"], eng.T_all,
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(rank["q_all"], eng.q_all,
                                   rtol=1e-10, atol=1e-10)
    # both processes hold the identical replicated result
    np.testing.assert_array_equal(ranks[0]["T_all"], ranks[1]["T_all"])


def test_two_process_pallas_streaming_acc(small_dataset, tmp_path):
    """The packed-word streaming scan across a REAL process boundary: 2
    gloo processes run streaming pass 1 (f32) under shard_map — both
    ranks must hold the identical replicated result, matching the
    sequential word-path engine to f32 accumulate-order tolerance."""
    from pyrhe_tpu.core.data import load_dataset
    from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig

    ds = small_dataset
    data = load_dataset(ds["prefix"], annot_file=ds["annot1_path"],
                        pheno_file=ds["pheno_path"],
                        cov_file=ds["cov_path"], num_random_vec=8, seed=7)
    cfg = RunConfig(num_random_vec=8, num_jack=10, seed=7,
                    dtype="float32", mm_mode="exact", packed_scan=True,
                    geno_impute_method="binary", streaming=True)
    eng = Engine(data, ModelSpec.build("rhe"), cfg)
    assert eng.packed_scan and eng.cfg.streaming
    eng.run_precompute_and_assemble()

    ranks = _run_workers(ds["dir"], str(tmp_path), streaming=True,
                         packed=True)
    np.testing.assert_array_equal(ranks[0]["T_all"], ranks[1]["T_all"])
    np.testing.assert_array_equal(ranks[0]["q_all"], ranks[1]["q_all"])
    for rank in ranks:
        np.testing.assert_allclose(rank["T_all"], eng.T_all,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(rank["q_all"], eng.q_all,
                                   rtol=1e-4, atol=1e-4)


def test_two_process_checkpoint_resume(small_dataset, tmp_path):
    """Sharded checkpointing across a real process boundary: each of the
    2 gloo processes snapshots its own shard slabs (shard_<pid>_of_2/);
    a re-run resumes from the done state on BOTH ranks without
    recomputing, bit-identical."""
    ds = small_dataset
    ck = str(tmp_path / "ck")
    first, logs1 = _run_workers(ds["dir"], str(tmp_path), streaming=True,
                                ckpt=ck, want_logs=True)
    assert os.path.isdir(os.path.join(ck, "shard_0_of_2"))
    assert os.path.isdir(os.path.join(ck, "shard_1_of_2"))
    assert not any("Resumed completed" in g for g in logs1)

    second, logs2 = _run_workers(ds["dir"], str(tmp_path), streaming=True,
                                 ckpt=ck, want_logs=True)
    assert all("Resumed completed" in g for g in logs2), logs2[0][-1500:]
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a["T_all"], b["T_all"])
        np.testing.assert_array_equal(a["q_all"], b["q_all"])
