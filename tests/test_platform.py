"""The GPU port's contracts, checked on the CPU: no silent fallback to the
CPU or to a guessed device size, the compile cache where it is asked for,
the CLI without pandas, and chip_smoke.py refusing to report without a
GPU."""
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    e = {**os.environ, "JAX_PLATFORMS": "cpu", **extra}
    e["PYTHONPATH"] = ROOT + os.pathsep + e.get("PYTHONPATH", "")
    e.pop("XLA_FLAGS", None)
    return e


@pytest.mark.parametrize("model", ["rhe", "genie"])
def test_cli_runs_without_pandas(small_dataset, tmp_path, model):
    """pandas is not on every host the CLI runs on: the whole CLI path
    (readers included) must run with the module made unimportable."""
    ds = small_dataset
    out = tmp_path / "out.txt"
    argv = ["-g", ds["prefix"], "-p", ds["pheno_path"], "-c", ds["cov_path"],
            "-annot", ds["annot8_path"], "-k", "4", "-jn", "4", "-s", "1",
            "--cov_one_hot_conversion", "-o", str(out), "--suppress"]
    if model == "genie":
        argv += ["--model", "genie", "-e", ds["env_path"]]
    prog = ("import sys; sys.modules['pandas'] = None\n"
            "from pyrhe_tpu.cli import cli_entry\n"
            f"cli_entry({argv!r})\n"
            "assert 'pandas' not in {m.split('.')[0] for m, v in "
            "sys.modules.items() if v is not None}\n")
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=_env(), cwd=tmp_path, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    sys.path.insert(0, ROOT)
    from parse_output import parse_output_file
    got = parse_output_file(str(out))
    assert len(got["sigma2_g"]) >= 8 and "total_h2" in got


def test_jaxcache_honours_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX keeps its cache there and
    the program sets no other directory."""
    cache = tmp_path / "cache"
    prog = ("import jax, jax.numpy as jnp\n"
            "from pyrhe_tpu.utils.jaxcache import (cache_dir,\n"
            "    enable_persistent_compilation_cache)\n"
            "enable_persistent_compilation_cache()\n"
            "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()\n"
            "print(jax.config.jax_compilation_cache_dir, cache_dir())\n")
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300,
                         env=_env(JAX_COMPILATION_CACHE_DIR=str(cache)))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == [str(cache), str(cache)]
    assert os.listdir(cache), "nothing cached in JAX_COMPILATION_CACHE_DIR"


def test_jaxcache_default_is_fixed_in_checkout():
    """Without the variable the cache is one fixed, git-ignored directory
    inside the checkout (the path is part of the cache key)."""
    env = _env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    prog = ("import jax\n"
            "from pyrhe_tpu.utils.jaxcache import (CACHE_DIR, cache_dir,\n"
            "    enable_persistent_compilation_cache)\n"
            "enable_persistent_compilation_cache()\n"
            "print(jax.config.jax_compilation_cache_dir, "
            "cache_dir(), CACHE_DIR)\n")
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    want = os.path.join(ROOT, ".jax_cache")
    assert res.stdout.split() == [want] * 3
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_pick_device_gpu_raises_on_cpu_host(small_dataset):
    """--device gpu on a host without one is an error, never a silent
    CPU run — through the engine and through the reference-named model
    API ('cuda' is the reference's name for the card)."""
    from pyrhe_tpu.core.engine import Engine
    from pyrhe_tpu.models import RHE

    with pytest.raises(RuntimeError, match="'gpu' requested"):
        Engine._pick_device(None, "gpu")
    assert Engine._pick_device(None, "cpu").platform == "cpu"
    ds = small_dataset
    for name in ("gpu", "cuda"):
        with pytest.raises(RuntimeError, match="'gpu' requested"):
            RHE(geno_file=ds["prefix"], annot_file=ds["annot1_path"],
                pheno_file=ds["pheno_path"], num_jack=4, num_random_vec=4,
                device=name)


def test_distributed_initialize_requires_coordinator(monkeypatch):
    """A multi-host join without its coordinator settings raises instead
    of continuing as independent single-process runs."""
    from pyrhe_tpu.parallel import distributed

    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="coordinator_address"):
        distributed.initialize()


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 989.0),
                                       ("NVIDIA H100 PCIe", 756.0),
                                       ("NVIDIA A100-SXM4-80GB", None),
                                       ("cpu", None)])
def test_bench_peak_lookup(kind, peak):
    """Utilization divides by the published bf16 peak of the device
    kind; an unknown kind is an error, not a default."""
    sys.path.insert(0, ROOT)
    import bench

    if peak is None:
        with pytest.raises(KeyError):
            bench.peak_tflops(kind)
    else:
        assert bench.peak_tflops(kind) == peak


def _no_ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return False
        except (ValueError, AttributeError):
            continue
    return True


def test_chip_smoke_fails_without_gpu():
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert res.returncode != 0
    assert _no_ok_line(res.stdout), res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script cannot find the program and must not report success."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = _env()
    env["PYTHONPATH"] = ""
    res = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=300)
    assert res.returncode != 0
    assert _no_ok_line(res.stdout), res.stdout
