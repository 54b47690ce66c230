"""Multi-host bootstrap.

Single-controller JAX spans hosts once `jax.distributed.initialize` has
run on every process; the sharded estimation step itself
(pyrhe_tpu.parallel.sharded.ShardedRunner) is host-count agnostic —
jackknife blocks shard over the global "jack" axis, every process stages
only the .bed byte ranges its own devices own
(ShardedRunner.owned_rows -> jax.make_array_from_process_local_data), and
the totals reduction is one XLA all-reduce across the cards.

Pattern (run the same program on every host, one process per host):

    import pyrhe_tpu.parallel.distributed as dist
    dist.initialize()                  # COORDINATOR_ADDRESS etc. from env
    data = load_dataset(prefix, ...)   # every host reads the small
                                       # tabular files; .bed stays lazy
    eng = Engine(data, spec, cfg)
    eng.run_sharded(dist.global_mesh())

Validated by tests/test_multihost.py: 2 CPU processes under
jax.distributed + gloo reproduce the sequential engine bit-for-bit.
"""
from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh


def initialize(**kwargs) -> None:
    """jax.distributed.initialize passthrough: pass kwargs, or set
    COORDINATOR_ADDRESS (host:port), NUM_PROCESSES and PROCESS_ID. A
    failed initialization raises — a multi-host run must never continue
    as independent single-process runs."""
    if kwargs:
        jax.distributed.initialize(**kwargs)
        return
    env = {k: os.environ[v] for k, v in
           (("coordinator_address", "COORDINATOR_ADDRESS"),
            ("num_processes", "NUM_PROCESSES"),
            ("process_id", "PROCESS_ID")) if v in os.environ}
    if "num_processes" in env:
        env["num_processes"] = int(env["num_processes"])
    if "process_id" in env:
        env["process_id"] = int(env["process_id"])
    missing = {"coordinator_address", "num_processes",
               "process_id"} - set(env)
    if missing:
        raise RuntimeError(
            "jax.distributed needs COORDINATOR_ADDRESS, NUM_PROCESSES and "
            f"PROCESS_ID; missing {sorted(missing)}")
    jax.distributed.initialize(**env)


def global_mesh(axis: str = "jack") -> Mesh:
    return Mesh(np.array(jax.devices()), (axis,))
