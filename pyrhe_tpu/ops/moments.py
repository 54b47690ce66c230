"""Fused per-block randomized-moment computation — the hot path.

For one jackknife block of m SNPs this computes every quadratic-form
statistic the RHE family needs (all bins, all components, all probes, all
traits) from TWO wide matmuls on the RAW dosage matrix:

    GP  = g  @ [1 | P | env_e ⊙ P ...]          (m, 1 + Bp*V)
    XXG = g^T @ [per-component masked/scaled U]  (N, Q)

Standardization is an affine map S = D(g - mean ⊗ 1), so it FOLDS into
rank-1 corrections around these matmuls instead of materializing the
standardized (m, N) matrix (reference standardize_geno base.py:291-296
materializes it; our first implementation did too and was HBM-bound on
it). The appended ones-column makes column sums — hence means and
variances — free byproducts of the first matmul. Dominance encoding is
affine in (g, g^2): enc = (mean+1) ⊙ g - g^2 (reference rhe_dom.py:23-41),
so RHE-DOM adds only a g^2 matmul pair. GxE statistics are env-scaled
probe columns (diag(env) X has X_e^T P = X^T (env ⊙ P), reference
genie.py:61-75 materializes X ⊙ env instead).

Precision modes (mm_mode): dosages are small integers, EXACT in bfloat16,
so only the probe-side operand limits accuracy:
  - "exact":  full-precision dot in the working dtype (float32 HIGHEST,
              or float64 on the CPU for parity)
  - "split2": probe operand split into bf16 hi+lo, side by side in ONE
              tensor-core pass with f32 accumulation (~1e-5 relative —
              beyond statistical noise) — the float32 default; the dosage
              side needs no split
  - "bf16":   single pass (~1e-3 relative), fastest

Compared to the reference's per-(bin, probe) matvec loop (rhe.py:13-22 +
base.py:403-417 + mat_mul.py:17-48 with per-call numpy->torch->device
round trips), one block here is two wide matmuls.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .decode import decode_packed_jnp, dosage_from_u8, impute


def split_hi_lo(x):
    """float32 x -> (hi, lo) bf16 with x ~= hi + lo to ~16 bits.

    hi rounds x to bf16 in integer arithmetic on its bit pattern (add
    half an ulp, clear the low 16 bits), so hi is exact in bf16 and
    x - hi is exact in float32. The obvious x - f32(bf16(x)) is not safe
    under XLA: with excess precision allowed (the GPU default) the
    simplifier drops the convert pair and the lo half becomes zero,
    silently reducing split2 to one bf16 pass."""
    x = x.astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(
        (bits + jnp.uint32(0x8000)) & jnp.uint32(0xFFFF0000), jnp.float32)
    return hi.astype(jnp.bfloat16), (x - hi).astype(jnp.bfloat16)


def _mm(a, b, mm_mode, out_dtype):
    """Matmul with dosage-exact mixed precision. `a` holds small integers
    (exact in bf16); `b` is the probe-side operand."""
    if mm_mode == "exact":
        return jnp.dot(a.astype(out_dtype), b.astype(out_dtype),
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=out_dtype)
    if mm_mode == "bf16":
        return jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    if mm_mode == "split2":
        # hi|lo side by side: ONE pass over the dosage operand
        W = b.shape[1]
        out = jnp.dot(a.astype(jnp.bfloat16),
                      jnp.concatenate(split_hi_lo(b), axis=1),
                      preferred_element_type=jnp.float32)
        return (out[:, :W] + out[:, W:]).astype(out_dtype)
    raise ValueError(f"unknown mm_mode {mm_mode}")


def _colsum(x):
    """Accurate reduction (mul+reduce, not dot — see normal_eq._gram)."""
    return jnp.sum(x, axis=0)


# Standardization scalars + per-component U rows used by _moment_algebra.
def _add_scale(mean):
    """Additive scale 1/sqrt(2p(1-p)) from the column mean (= 2p)."""
    var_add = mean * (1.0 - 0.5 * mean)
    return jnp.where(var_add > 0,
                     jax.lax.rsqrt(jnp.maximum(var_add, 1e-30)), 0.0)


def _dom_scales(mean, mean2):
    """Dominance-encoding scalars (reference rhe_dom.py:15-41): scale
    1/(2·maf·(1−maf)), alpha with enc = alpha·g − g², and the encoded
    column mean."""
    maf = mean / 2.0
    denom = 2.0 * maf * (1.0 - maf)
    d_dom = jnp.where(denom > 0, 1.0 / jnp.maximum(denom, 1e-30), 0.0)
    alpha = mean + 1.0
    mean_enc = alpha * mean - mean2
    return d_dom, alpha, mean_enc


def _u_add(d_add, mean, GPr, s_r):
    """Standardized-X'P rows for an additive component via the rank-1
    fold (module docstring)."""
    return d_add[:, None] * (GPr - mean[:, None] * s_r[None, :])


def _u_dom(d_dom, alpha, mean_enc, GPr, G2Pr, s_r):
    """Standardized-X'P rows for a dominance component: the encoding is
    affine in (g, g²)."""
    return d_dom[:, None] * (alpha[:, None] * GPr - G2Pr
                             - mean_enc[:, None] * s_r[None, :])


def _stage1_cols(components, P, env, mask_col):
    """Stage-1 right operand [mask/ones | P per env VARIANT]: the leading
    column makes column sums — hence means/variances — free byproducts of
    the first matmul. Returns (variants, C_all)."""
    variants = []
    for _, eidx in components:
        if eidx not in variants:
            variants.append(eidx)
    cols = [mask_col]
    for v in variants:
        cols.append(P if v is None
                    else P * env[:, v][:, None].astype(P.dtype))
    return variants, jnp.concatenate(cols, axis=1)


def _component_stats(kind, U, annot_f, b2, d, mean_stat, alpha=None):
    """Per-component yXXy entry and stage-2 operands from the U rows.
    Returns (ys, Y_g, Y_g2, rank1): Y_g rides the g contraction,
    Y_g2 (dominance only, else None) the g² one; rank1 is the
    standardization fold's correction row."""
    m, K = annot_f.shape
    Uy = U[:, b2:]
    ys = jnp.sum((Uy * Uy)[:, None, :] * annot_f[:, :, None], axis=0)
    W = (U[:, None, :b2] * annot_f[:, :, None]).reshape(m, K * b2)
    Yd = d[:, None] * W
    rank1 = jnp.sum(mean_stat[:, None] * Yd, axis=0)
    if kind == "add":
        return ys, Yd, None, rank1
    return ys, alpha[:, None] * Yd, -Yd, rank1


def block_stats_core(
    geno,           # (m, bytes_per_snp) packed u8 OR (m, N) dosage u8
    fill,           # (m,) imputation fill values
    annot_f,        # (m, K) float annot block
    P,              # (N, Bp) probe matrix [Z | Uz? | y~ traits]
    env,            # (N, num_env) or None
    *,
    n_indiv: int,
    components: tuple,   # (("add"|"dom", env_idx|None), ...)
    b2: int,             # probe columns that participate in XXP (B or 2B)
    packed: bool,
    dtype=jnp.float32,
    mm_mode: str = "exact",
    valid_mask=None,     # (N,) 1.0 at kept individuals, or None (all)
):
    """Returns (XXP (n_comp*K, N, b2), yXXy (n_comp*K, T), M (n_comp*K,)).

    The N = P.shape[0] columns decoded are the individuals of the probe
    matrix. With valid_mask, rows of the .bed population that were
    filtered out (missing phenotype/covariate) are decoded but carry zero
    weight: the mask replaces the stage-1 ones column (so means and
    variances cover the n_indiv kept individuals only) and zeroes their
    stage-2 output rows, and P/env hold zero rows there.

    Un-jitted core, reused under jit (block_stats), lax.scan (the chunked
    drivers) and shard_map (pyrhe_tpu.parallel)."""
    N = P.shape[0]
    if packed:
        g, miss = decode_packed_jnp(geno, N, dtype)
    else:
        g, miss = dosage_from_u8(geno, dtype)
    g = impute(g, miss, fill)
    if mm_mode != "exact":
        g = g.astype(jnp.bfloat16)  # dosages are exact in bf16

    need_dom = any(kind == "dom" for kind, _ in components)
    g2 = (g * g) if need_dom else None
    mm1 = lambda which, C: _mm(g if which == "g" else g2, C, mm_mode, dtype)
    mm2 = lambda which, Y: _mm((g if which == "g" else g2).T, Y, mm_mode,
                               dtype)
    return _moment_algebra(mm1, mm2, N, annot_f, P, env,
                           n_indiv=n_indiv, components=components, b2=b2,
                           dtype=dtype, valid_mask=valid_mask)


def _moment_algebra(mm1, mm2, N, annot_f, P, env, *, n_indiv, components,
                    b2, dtype, valid_mask=None):
    """Post-matmul algebra. mm1(which, C) computes g@C / g2@C over an
    (N, W) right operand; mm2(which, Y) computes g^T@Y / g2^T@Y over an
    (m, Q) right operand, returning N rows (rows of filtered individuals
    zeroed by valid_mask)."""
    m, K = annot_f.shape
    Bp = P.shape[1]

    # ---- stage 1: one wide matmul over all env variants + ones column ----
    mask_col = (jnp.ones((N, 1), dtype) if valid_mask is None
                else valid_mask[:, None].astype(dtype))
    variants, C_all = _stage1_cols(components, P, env, mask_col)
    csum = _colsum(C_all)                          # exact column sums

    need_dom = any(kind == "dom" for kind, _ in components)
    GP = mm1("g", C_all)                           # (m, 1 + Bp*V)
    G2P = mm1("g2", C_all) if need_dom else None

    mean = GP[:, 0] / n_indiv
    d_add = _add_scale(mean)
    if need_dom:
        d_dom, alpha, mean_enc = _dom_scales(mean, G2P[:, 0] / n_indiv)

    # ---- per-component U, yXXy, and stage-2 right-hand operands ----
    ys, Y_g_list, Y_g2_list, rank1_list, scales = [], [], [], [], []
    for kind, eidx in components:
        v = variants.index(eidx)
        sl = slice(1 + v * Bp, 1 + (v + 1) * Bp)
        GPr, s_r = GP[:, sl], csum[sl]
        if kind == "add":
            U = _u_add(d_add, mean, GPr, s_r)
            ys_e, Yg, Y2, r1 = _component_stats("add", U, annot_f, b2,
                                                d_add, mean)
        else:
            U = _u_dom(d_dom, alpha, mean_enc, GPr, G2P[:, sl], s_r)
            ys_e, Yg, Y2, r1 = _component_stats("dom", U, annot_f, b2,
                                                d_dom, mean_enc, alpha)
        ys.append(ys_e)                            # (K, T)
        Y_g_list.append(Yg)
        Y_g2_list.append(Y2)
        rank1_list.append(r1)
        scales.append(None if eidx is None else env[:, eidx])

    # ---- stage 2: one wide g^T matmul (+ one g2^T matmul for dominance) ----
    YG = jnp.concatenate(Y_g_list, axis=1)         # (m, n_comp*K*b2)
    XXG = mm2("g", YG)                             # (N, Q)
    dom_cols = [y for y in Y_g2_list if y is not None]
    XXG2 = mm2("g2", jnp.concatenate(dom_cols, axis=1)) if dom_cols else None

    XXPs = []
    q = K * b2
    dom_off = 0
    for i, (kind, eidx) in enumerate(components):
        part = XXG[:, i * q:(i + 1) * q]
        if kind == "dom":
            part = part + XXG2[:, dom_off * q:(dom_off + 1) * q]
            dom_off += 1
        part = part - rank1_list[i][None, :]
        if scales[i] is not None:
            part = part * scales[i][:, None].astype(part.dtype)
        if valid_mask is not None:
            part = part * valid_mask[:, None].astype(part.dtype)
        XXPs.append(part.reshape(N, K, b2).transpose(1, 0, 2))

    M_blk = jnp.sum(annot_f, axis=0).astype(jnp.int32)
    M_all = jnp.concatenate([M_blk] * len(components))
    return (jnp.concatenate(XXPs, axis=0),
            jnp.concatenate(ys, axis=0).astype(dtype), M_all)


block_stats = partial(
    jax.jit,
    static_argnames=("n_indiv", "components", "b2", "packed", "dtype",
                     "mm_mode"),
)(block_stats_core)


def nxe_stats(env, Z, Uzb, Y, b2, B, dtype=jnp.float32):
    """Analytic hetero-noise (NxE) component statistics.

    The NxE pseudo-genotype is diag(env_e), so XXz = env_e^2 ⊙ z and
    yXXy = ||env_e ⊙ y~||^2 — computed in O(N) instead of materializing the
    N x N diagonal matrix like the reference (base.py:472-481,
    base_streaming.py:44-58).

    Returns (XXP (num_env, N, b2), yXXy (num_env, T)).
    """
    e2 = (env * env).T[:, :, None].astype(dtype)          # (num_env, N, 1)
    cols = [e2 * Z[None, :, :]]
    if b2 > B:
        cols.append(e2 * Uzb[None, :, :])
    XXP = jnp.concatenate(cols, axis=2)                   # (num_env, N, b2)
    ey = env.T[:, :, None] * Y[None, :, :]                # (num_env, N, T)
    yXXy = jnp.sum(ey * ey, axis=1).astype(dtype)         # (num_env, T)
    return XXP, yXXy
