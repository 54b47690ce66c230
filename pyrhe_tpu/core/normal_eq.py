"""Per-jackknife-sample normal-equation assembly (device-side).

Builds the (E+1, E+1) LHS T and (E+1, T_traits) RHS q of the method-of-
moments system from leave-one-out moment statistics.

Behavioral spec: reference base.py:568-628 (setup_lhs_rhs_jackknife):
  T[k,l] = [<XXz_k, XXz_l> + <XXUz_k, UXXz_l> - 2 <proj XXz_k, XXz_l>]
             / num_random_vec / (M_k * M_l)      (0 when M_k*M_l == 0)
  T[k,E] = b_tr(k) - <XXz_k, Uzb> / (B * M_k)    (the subtraction only
             with covariates; b_tr is N for standardized genotype
             components, stochastic for GxE/NxE rows, genie.py:84-94)
  T[E,E] = N - #cov
  q[k]   = yXXy_k / M_k;  q[E] = y~^T y~

The covariate-projected stats UXXz = C Q C^T XXz are DERIVED here by
linearity instead of being accumulated per block like the reference
(base.py:407-412) — projection commutes with the leave-one-out sums.

Implementation notes: all length-(N*B) contractions are multiply+reduce
(vmap'd), NOT dot products — XLA's dot lowering accumulates long
reductions at reduced precision (measured ~1.5e-7 relative on CPU
float64), which is catastrophic for these positive quadratic forms. The
few remaining matmuls (the covariate projection) ask for HIGHEST
precision, so a float32 run never drops to TF32 on the GPU.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _gram(A, B):
    """(E, N, B), (F, N, B) -> (E, F) pairwise inner products via
    vmap'd multiply+reduce."""
    return jax.vmap(lambda a: jnp.sum(a[None, :, :] * B, axis=(1, 2)))(A)


def _dotvec(A, V):
    """(E, N, B), (N, B) -> (E,) accurate inner products."""
    return jnp.sum(A * V[None, :, :], axis=(1, 2))


def project_cov(C, Q, XXz):
    """C Q C^T applied to each (N, B) slice of XXz (E, N, B).

    The length-N contraction uses multiply+reduce (see _gram); the tiny
    length-ncov contractions use einsum."""
    t = jax.vmap(
        lambda x: jnp.sum(C[:, :, None] * x[:, None, :], axis=0))(XXz)
    hi = jax.lax.Precision.HIGHEST
    t = jnp.einsum("cd,edb->ecb", Q, t, precision=hi)   # (E, ncov, B)
    return jnp.einsum("nc,ecb->enb", C, t, precision=hi)


def assemble_Tq_core(
    XXP,          # (E, N, b2) leave-one-out moment stats
    yXXy,         # (E, T) leave-one-out quadratic forms
    M,            # (E,) leave-one-out SNP counts
    Z,            # (N, B) probes
    Uzb,          # (N, B) projected probes, or zeros when no covariates
    C,            # (N, ncov) covariates or None
    Q,            # (ncov, ncov) pinv(C^T C) or None
    q_last,       # (T,) y~^T y~ per trait
    stoch_mask,   # (E,) bool: stochastic border-trace rows (GxE/NxE)
    *,
    num_random_vec: int,
    n_indiv: int,
    n_cov: int,
):
    B = num_random_vec
    dtype = XXP.dtype
    XXz = XXP[:, :, :B]

    G1 = _gram(XXz, XXz)
    if C is not None:
        XXUz = XXP[:, :, B:]
        UXXz = project_cov(C, Q, XXz)
        G2 = _gram(UXXz, XXz)
        G3 = _gram(XXUz, UXXz)
        raw = G1 + G3 - 2.0 * G2
    else:
        raw = G1

    Mf = M.astype(dtype)
    MM = Mf[:, None] * Mf[None, :]
    T_top = jnp.where(MM != 0, raw / B / jnp.where(MM == 0, 1.0, MM), 0.0)

    Msafe = jnp.where(Mf == 0, 1.0, Mf)
    zdot = _dotvec(XXz, Z) / (B * Msafe)
    btr = jnp.where(stoch_mask, zdot, jnp.asarray(float(n_indiv), dtype))
    if C is not None:
        btr = btr - _dotvec(XXz, Uzb) / (B * Msafe)

    corner = jnp.asarray([[float(n_indiv - n_cov)]], dtype)
    T = jnp.concatenate([
        jnp.concatenate([T_top, btr[:, None]], axis=1),
        jnp.concatenate([btr[None, :], corner], axis=1),
    ], axis=0)

    q_top = jnp.where(Mf[:, None] != 0, yXXy / Msafe[:, None], 0.0)
    q = jnp.concatenate([q_top, q_last[None, :].astype(dtype)], axis=0)
    return T, q


assemble_Tq = partial(
    jax.jit, static_argnames=("num_random_vec", "n_indiv", "n_cov"),
)(assemble_Tq_core)


def assemble_Tq_chunk_core(
    tot_XXP,      # (E_geno, N, b2) pass-1 totals
    tot_y,        # (E_geno, T)
    blocks_XXP,   # (C, E_geno, N, b2) per-block stats (zeros row => total)
    blocks_y,     # (C, E_geno, T)
    M_rows,       # (C, E) leave-one-out counts
    nxe_XXP,      # (num_nxe, N, b2) or (0, N, b2)
    nxe_y,        # (num_nxe, T) or (0, T)
    Z, Uzb, C, Q, q_last, stoch_mask,
    *,
    num_random_vec: int,
    n_indiv: int,
    n_cov: int,
):
    """Batched leave-one-out + normal-equation assembly: C jackknife
    samples per device dispatch (scan over assemble_Tq_core). One call
    replaces C per-sample dispatches."""
    def body(_, xs):
        bX, by, M = xs
        X = tot_XXP - bX
        y = tot_y - by
        if nxe_XXP.shape[0]:
            X = jnp.concatenate([X, nxe_XXP], axis=0)
            y = jnp.concatenate([y, nxe_y], axis=0)
        T, q = assemble_Tq_core(
            X, y, M, Z, Uzb, C, Q, q_last, stoch_mask,
            num_random_vec=num_random_vec, n_indiv=n_indiv, n_cov=n_cov)
        return None, (T, q)

    # lax.scan, not vmap: the body compiles ONCE regardless of C and
    # holds one sample's (E, N, b2) working set, and one dispatch covers
    # all C samples.
    _, (T, q) = jax.lax.scan(body, None, (blocks_XXP, blocks_y, M_rows))
    return T, q


assemble_Tq_chunk = partial(
    jax.jit, static_argnames=("num_random_vec", "n_indiv", "n_cov"),
)(assemble_Tq_chunk_core)


