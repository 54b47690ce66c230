"""Benchmark: genotype randomized-matvec throughput per device.

Times the pass-1 shape — a jitted scan over packed .bed blocks resident
in device memory, each decode+standardize+moment-matmul, accumulating
totals — and prints ONE JSON line:

  {"metric": "genotype_matvec_gflops_per_chip", "value": ..., "unit":
   "GFLOP/s", "vs_baseline": ..., "device": {...}}

Timing: all block results accumulate into one carry inside a single
jitted scan, the carry is pulled to the host to synchronize, and the
MARGINAL rate between a short and a long scan is reported, cancelling
the fixed dispatch latency. Utilization is against the dense bf16 peak
of the device kind (PEAK_BF16_TFLOPS); a CPU run reports none.

FLOP accounting (useful flops only): 2*N*m*(Bp + K*b2) per block.

Baseline: PyRHE publishes wall-clock only (BASELINE.md). Its best
published config — N=200k, k=10, 1 bin, J=100, 5 workers, 450.53 s
(plotting_200k.ipynb cell 6) on ~500k UKBB SNPs — corresponds to
4*N*M*k ≈ 4e12 FLOP / 450.53 s ≈ 8.9 GFLOP/s. vs_baseline = value / 8.9.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np


def bench_scan(N, m, K, B, n_blocks_short, n_blocks_long, dtype_mode="float32",
               use_cov=False, num_env=0, dom=False):
    import jax
    import jax.numpy as jnp

    from pyrhe_tpu.io.bed import clean_packed
    from pyrhe_tpu.ops.moments import block_stats_core

    T = 1
    b2 = B * (2 if use_cov else 1)   # covariates double the probe block
    Bp = b2 + T
    components = (("add", None),) + tuple(
        ("add", e) for e in range(num_env))   # GENIE G+GxE shape
    if dom:
        components += (("dom", None),)       # RHE-DOM shape
    rng = np.random.default_rng(0)
    dev = jax.devices()[0]

    annot = np.zeros((m, K), np.float32)
    annot[np.arange(m), rng.integers(0, K, m)] = 1.0
    annot_d = jax.device_put(annot, dev)
    fill = jax.device_put(np.zeros(m, np.float32), dev)
    mask = jax.device_put(np.ones(N, np.float32), dev)
    mm_mode = {"float32": "split2", "bfloat16": "bf16",
               "exact": "exact"}[dtype_mode]
    P = jax.device_put(rng.normal(size=(N, Bp)).astype(np.float32), dev)
    env = (jax.device_put(rng.normal(size=(N, num_env)).astype(np.float32),
                          dev) if num_env else None)
    nb = (N + 3) // 4

    def stats(blk):
        # the engine's packed-scan block: host-cleaned packed bytes,
        # decoded on the device (Engine._scan_stats_fn)
        return block_stats_core(
            blk, fill, annot_d, P, env, n_indiv=N, components=components,
            b2=b2, packed=True, dtype=jnp.float32, mm_mode=mm_mode,
            valid_mask=mask)

    def make_scan(n_blocks):
        raw = rng.integers(0, 256, size=(n_blocks, m, nb), dtype=np.uint8)
        fills = rng.integers(0, 3, size=m).astype(np.float64)
        for b in range(n_blocks):
            clean_packed(raw[b], fills, out=raw[b])
        blocks = jax.device_put(raw, dev)

        @jax.jit
        def run(blocks):
            E = len(components) * K

            def body(carry, blk):
                XXP, yXXy, _ = stats(blk)
                return (carry[0] + XXP, carry[1] + yXXy), None

            init = (jnp.zeros((E, N, b2), jnp.float32),
                    jnp.zeros((E, T), jnp.float32))
            (tot, toty), _ = jax.lax.scan(body, init, blocks)
            return jnp.sum(tot) + jnp.sum(toty)

        return run, blocks

    times = {}
    for nblk in (n_blocks_short, n_blocks_long):
        run, blocks = make_scan(nblk)
        float(run(blocks))  # warmup/compile + sync
        best = float("inf")
        for _ in range(7):
            t0 = time.perf_counter()
            s = float(run(blocks))   # host pull = true sync
            best = min(best, time.perf_counter() - t0)
        times[nblk] = best
        assert np.isfinite(s)
    marginal = (times[n_blocks_long] - times[n_blocks_short]) / (
        n_blocks_long - n_blocks_short)
    if not marginal > 0:
        # Timing noise swamped the subtraction (seen on fast CPU runs
        # where per-block work ~ jitter). Fall back to the long scan's
        # average rate — conservative but always positive.
        marginal = times[n_blocks_long] / n_blocks_long
    # stage 1: Bp probe columns per env VARIANT (doubled when dominance
    # needs the g² pass); stage 2: K*b2 per component, doubled for each
    # dominance component (its stats are a g plus a g² contraction) —
    # useful flops only, ones/mask column excluded as before
    V = 1 + num_env
    n_dom = sum(1 for kind, _ in components if kind == "dom")
    s2_widths = len(components) * K * b2 + n_dom * K * b2
    flops_per_block = 2.0 * N * m * (Bp * V * (2 if n_dom else 1)
                                     + s2_widths)
    return flops_per_block / marginal / 1e9


# Dense bf16 tensor-core peaks (TFLOP/s) by jax device_kind, from NVIDIA's
# H100 data sheet (SXM and PCIe parts, without sparsity). A device that
# is not listed is an error: utilization is never divided by a guess.
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,      # SXM5
    "NVIDIA H100 PCIe": 756.0,
}


def peak_tflops(device_kind: str) -> float:
    if device_kind not in PEAK_BF16_TFLOPS:
        raise KeyError(f"no bf16 peak known for device kind "
                       f"{device_kind!r}; add it to PEAK_BF16_TFLOPS")
    return PEAK_BF16_TFLOPS[device_kind]


def main():
    import jax

    from pyrhe_tpu.utils.jaxcache import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()

    dev = jax.devices()[0]
    on_acc = dev.platform != "cpu"
    mode = os.environ.get("BENCH_DTYPE", "float32")
    # production-shape overrides: BENCH_K=8 BENCH_COV=1 is the 8-bin +
    # covariates configuration (stage-2 width K*b2 = 160)
    K = int(os.environ.get("BENCH_K", 1))
    B = int(os.environ.get("BENCH_B", 10))
    cov = os.environ.get("BENCH_COV", "0") == "1"
    # BENCH_ENV=E adds E GxE components (GENIE G+GxE shape): stage 1
    # gains E env-scaled probe variants, stage 2 K*b2 columns each
    num_env = int(os.environ.get("BENCH_ENV", 0))
    # BENCH_DOM=1 adds a dominance component (RHE-DOM shape): stage 1
    # doubles (g² pass), the dom component's stage 2 runs both
    # contractions
    dom = os.environ.get("BENCH_DOM", "0") == "1"
    if on_acc:
        args, blocks = (131072, 2048), (8, 32)
    else:
        args, blocks = (8192, 512), (2, 6)
    if os.environ.get("BENCH_M"):      # block-size override (SNP rows)
        args = (args[0], int(os.environ["BENCH_M"]))
    gflops = bench_scan(*args, K, B, *blocks, mode, cov, num_env, dom)

    # Second measured shape: the wide production config (8 annotation
    # bins + covariates -> stage-2 width K*b2 = 160). The K=1,B=10
    # headline is the narrow worst case (21 probe columns); the wide row
    # shows what production configs sustain. Skipped if the overrides
    # already ask for it. The wide row uses the block shape of M=500k at
    # J=100 (m=5120): per-block stats accumulate traffic is constant per
    # block, so utilization rises with block size.
    wide_cfg = {"K": 8, "B": B, "cov": True}
    wide_m = 5120 if on_acc else args[1]
    wide_blocks = (4, 16) if on_acc else blocks
    wide_gflops = (gflops
                   if (K, cov, num_env, dom) == (8, True, 0, False)
                   and args[1] == wide_m
                   else bench_scan(args[0], wide_m, wide_cfg["K"],
                                   wide_cfg["B"], *wide_blocks, mode,
                                   wide_cfg["cov"]))

    baseline_gflops = 8.9  # PyRHE CPU-equivalent, see module docstring
    peak = peak_tflops(dev.device_kind) if on_acc else None

    def mfu(g):
        # no utilization for a CPU run: there is no device peak to
        # divide by
        return round(100 * g / (peak * 1e3), 2) if peak else None

    print(json.dumps({
        "metric": "genotype_matvec_gflops_per_chip",
        "value": round(gflops, 2),
        "unit": "GFLOP/s",
        "vs_baseline": round(gflops / baseline_gflops, 2),
        "mfu_pct": mfu(gflops),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "config": {"K": K, "B": B, "cov": cov, "dtype": mode,
                   **({"env": num_env} if num_env else {}),
                   **({"dom": True} if dom else {})},
        "wide": {"value": round(wide_gflops, 2),
                 "vs_baseline": round(wide_gflops / baseline_gflops, 2),
                 "mfu_pct": mfu(wide_gflops),
                 "config": {**wide_cfg, "m": wide_m}},
        "note": ("useful-FLOP utilization vs the dense bf16 peak of "
                 "the device kind; 'wide' is the 8-bin+cov config at "
                 "block shape m=5120 (M=500k, J=100)"),
    }))


if __name__ == "__main__":
    main()
