"""Multi-host worker: one process of a 2-process CPU jax.distributed run.

Usage: python _mh_worker.py <process_id> <num_processes> <port> <data_dir>
                            <out_npz> [streaming]

Each process sees 2 local CPU devices (4 global), loads the SAME dataset,
and runs the sharded engine over the global mesh — the pattern of a
multi-host run (one process per host, jax.distributed.initialize, every
process constructs the same Engine and calls run_sharded).
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

pid, nproc, port, data_dir, out_npz = sys.argv[1:6]
extras = sys.argv[6:]
streaming = "streaming" in extras
packed = "packed" in extras       # f32 chunked packed-byte scan
ckpt_dir = next((a.split("=", 1)[1] for a in extras
                 if a.startswith("ckpt=")), None)

import jax  # noqa: E402
from jax.extend.backend import clear_backends  # noqa: E402

clear_backends()
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=int(nproc), process_id=int(pid))

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pyrhe_tpu.core.data import load_dataset  # noqa: E402
from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig  # noqa: E402
from pyrhe_tpu.parallel.mesh import make_mesh  # noqa: E402

assert jax.process_count() == int(nproc)
assert len(jax.devices()) == 2 * int(nproc)

prefix = os.path.join(data_dir, "test")
data = load_dataset(prefix,
                    annot_file=os.path.join(data_dir, "single.annot"),
                    pheno_file=prefix + ".pheno",
                    cov_file=os.path.join(data_dir, "test.cov"),
                    num_random_vec=8, seed=7)
cfg = RunConfig(num_random_vec=8, num_jack=10, seed=7,
                dtype=("float32" if packed else "float64"),
                mm_mode=("exact" if packed else "auto"),
                packed_scan=packed,
                geno_impute_method="binary", streaming=streaming,
                checkpoint_dir=ckpt_dir)
eng = Engine(data, ModelSpec.build("rhe"), cfg)
if packed:
    assert eng.packed_scan
eng.run_sharded(make_mesh())
np.savez(out_npz, T_all=eng.T_all, q_all=eng.q_all)
print(f"worker {pid} done", flush=True)
