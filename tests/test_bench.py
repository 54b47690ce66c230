"""Guard the driver-facing bench.py contract: it must print exactly one
JSON line with the headline metric and a finite positive value on any
backend (the round driver runs it unattended at round end)."""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def test_bench_scan_smoke():
    sys.path.insert(0, ROOT)
    import bench

    gflops = bench.bench_scan(1024, 128, 1, 4, 2, 4, "float32")
    assert gflops > 0 and gflops == gflops  # finite, positive


def test_bench_main_json_contract():
    prog = (
        f"import sys; sys.path.insert(0, {ROOT!r})\n"
        "import bench\n"
        "bench.main()\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", prog],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    line = res.stdout.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["metric"] == "genotype_matvec_gflops_per_chip"
    assert out["unit"] == "GFLOP/s"
    assert out["value"] > 0
    assert out["vs_baseline"] > 0
    # a CPU run names its device and claims no utilization: there is no
    # device peak to divide by
    assert out["device"]["platform"] == "cpu"
    assert out["mfu_pct"] is None
    assert out["wide"]["value"] > 0
    assert out["wide"]["mfu_pct"] is None
    assert out["wide"]["config"]["K"] == 8 and out["wide"]["config"]["cov"]
