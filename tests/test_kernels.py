"""Block-stats paths on packed genotypes: the host clean of missing codes
and the packed-byte decode (the accelerator's main path) against the
host-decoded dosage path."""
import jax.numpy as jnp
import numpy as np
import pytest

from pyrhe_tpu.io.bed import encode_dosage
from pyrhe_tpu.ops.moments import block_stats, split_hi_lo


def make_inputs(m=300, n=700, seed=0, missing=True):
    rng = np.random.default_rng(seed)
    dos = rng.integers(0, 3, size=(m, n)).astype(np.uint8)
    if missing:
        dos[rng.random((m, n)) < 0.05] = 255
    fill = rng.integers(0, 3, size=m).astype(np.float64)
    return dos, fill


@pytest.mark.parametrize("components", [
    (("add", None),),
    (("add", None), ("dom", None)),
    (("add", None), ("add", 0)),
])
def test_block_stats_pallas_matches_jnp(components):
    """Host-cleaned packed bytes (missing codes rewritten to the fills,
    io/bed.clean_packed) decoded on the device give the same block stats
    as the host-decoded uint8 dosages imputed on the device."""
    from pyrhe_tpu.io.bed import clean_packed

    dos, fill = make_inputs(seed=2)
    m, n = dos.shape
    rng = np.random.default_rng(3)
    K, B, T = 2, 4, 1
    annot = np.zeros((m, K), np.float32)
    annot[np.arange(m), rng.integers(0, K, m)] = 1.0
    P = rng.normal(size=(n, B + T)).astype(np.float32)
    env = (rng.random((n, 1)) < 0.5).astype(np.float32)
    kw = dict(n_indiv=n, components=components, b2=B, dtype=jnp.float32,
              mm_mode="exact")

    host = block_stats(jnp.asarray(dos), jnp.asarray(fill, jnp.float32),
                       jnp.asarray(annot), jnp.asarray(P), jnp.asarray(env),
                       packed=False, **kw)
    clean = clean_packed(encode_dosage(dos), fill)
    dev = block_stats(jnp.asarray(clean), jnp.zeros(m, jnp.float32),
                      jnp.asarray(annot), jnp.asarray(P), jnp.asarray(env),
                      packed=True, valid_mask=jnp.ones(n, jnp.float32),
                      **kw)
    for a, b in zip(dev, host):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)


def test_clean_packed_removes_missing():
    from pyrhe_tpu.io.bed import clean_packed, decode_packed

    rng = np.random.default_rng(7)
    dos = rng.integers(0, 3, size=(64, 213)).astype(np.uint8)
    dos[rng.random(dos.shape) < 0.2] = 255
    packed = encode_dosage(dos)
    fill = rng.integers(0, 3, size=64)
    cleaned = clean_packed(packed, fill.astype(np.float64))
    out = decode_packed(cleaned, 213)
    expect = np.where(dos == 255, fill[:, None], dos)
    np.testing.assert_array_equal(out, expect)
    # padded wide output: trailing bytes zeroed
    wide = np.full((64, packed.shape[1] + 5), 9, np.uint8)
    clean_packed(packed, fill.astype(np.float64), out=wide)
    assert np.all(wide[:, packed.shape[1]:] == 0)
    np.testing.assert_array_equal(decode_packed(
        wide[:, :packed.shape[1]], 213), expect)


def test_valid_mask_equals_filtered_matrix():
    """Decoding the full population with dropped individuals masked out
    (zero probe rows, zero mask) gives the stats of the host-filtered
    matrix at the kept rows, and zero rows elsewhere."""
    from pyrhe_tpu.io.bed import clean_packed

    dos, fill = make_inputs(m=200, n=500, seed=4)
    m, n = dos.shape
    rng = np.random.default_rng(5)
    keep = np.sort(rng.choice(n, size=430, replace=False))
    comps = (("add", None), ("dom", None), ("add", 0))
    annot = np.zeros((m, 3), np.float32)
    annot[np.arange(m), rng.integers(0, 3, m)] = 1.0
    P = rng.normal(size=(len(keep), 5)).astype(np.float32)
    env = rng.normal(size=(len(keep), 1)).astype(np.float32)
    kw = dict(n_indiv=len(keep), components=comps, b2=4, dtype=jnp.float32,
              mm_mode="exact")

    # fills drawn on the filtered data, as Engine._fill_from_stats does
    filt = block_stats(jnp.asarray(dos[:, keep]),
                       jnp.asarray(fill, jnp.float32), jnp.asarray(annot),
                       jnp.asarray(P), jnp.asarray(env), packed=False, **kw)
    P_full = np.zeros((n, 5), np.float32)
    P_full[keep] = P
    env_full = np.zeros((n, 1), np.float32)
    env_full[keep] = env
    mask = np.zeros(n, np.float32)
    mask[keep] = 1.0
    full = block_stats(jnp.asarray(clean_packed(encode_dosage(dos), fill)),
                       jnp.zeros(m, jnp.float32), jnp.asarray(annot),
                       jnp.asarray(P_full), jnp.asarray(env_full),
                       packed=True, valid_mask=jnp.asarray(mask), **kw)
    XXP = np.asarray(full[0])
    np.testing.assert_allclose(XXP[:, keep], np.asarray(filt[0]),
                               rtol=1e-4, atol=1e-3)
    assert np.all(XXP[:, np.setdiff1d(np.arange(n), keep)] == 0)
    np.testing.assert_allclose(np.asarray(full[1]), np.asarray(filt[1]),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_split_hi_lo_keeps_16_bits(scale):
    """split2's probe split: hi is exact in bf16, hi + lo recovers x to
    ~2^-17 relative, and lo is not silently zero (the XLA excess-
    precision hazard, docs/design/precision.md)."""
    import jax

    x = np.random.default_rng(1).normal(size=4096).astype(np.float32) * scale
    hi, lo = jax.jit(split_hi_lo)(jnp.asarray(x))
    hi64 = np.asarray(hi, np.float64)
    lo64 = np.asarray(lo, np.float64)
    np.testing.assert_array_equal(
        np.asarray(hi.astype(jnp.float32)).view(np.uint32) & 0xFFFF, 0)
    err = np.abs(hi64 + lo64 - x) / np.abs(x)
    assert err.max() < 2.0 ** -16
    assert np.count_nonzero(lo64) > 0.9 * x.size


@pytest.mark.parametrize("mm_mode,rtol", [("split2", 5e-5), ("bf16", 2e-2)])
def test_mm_modes_match_exact(mm_mode, rtol):
    """Both reduced-precision matmul modes stay inside their stated
    envelope of the exact float32 product on an integer dosage operand."""
    import jax

    from pyrhe_tpu.ops.moments import _mm

    rng = np.random.default_rng(9)
    g = rng.integers(0, 3, size=(64, 2048)).astype(np.float32)
    C = rng.normal(size=(2048, 12)).astype(np.float32)
    ref = g.astype(np.float64) @ C.astype(np.float64)
    got = np.asarray(jax.jit(lambda a, b: _mm(a, b, mm_mode, jnp.float32))(
        jnp.asarray(g), jnp.asarray(C)))
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()
