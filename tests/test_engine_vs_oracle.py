"""Engine (float64, CPU) vs NumPy oracle parity on synthetic data.

The oracle computes the reference algorithm the reference's way (gathered
per-bin submatrices, per-slot accumulation); the engine uses the fused
masked-bin formulation — agreement validates the redesign's math.
"""
import numpy as np
import pytest

from conftest import load_geno_nan
from oracle_numpy import Oracle

from pyrhe_tpu.core.data import load_dataset
from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig
from pyrhe_tpu.core import solver as S

N, M = 600, 800


def run_engine(ds, model="rhe", genie_model="G", annot_key="annot1_path",
               cov=False, env=False, J=8, B=8, seed=7, impute="binary",
               streaming=False):
    data = load_dataset(
        ds["prefix"],
        annot_file=ds[annot_key],
        pheno_file=ds["pheno_path"],
        cov_file=ds["cov_path"] if cov else None,
        env_file=ds["env_path"] if env else None,
        num_random_vec=B, seed=seed,
    )
    spec = ModelSpec.build(model, genie_model, data.num_env)
    cfg = RunConfig(num_random_vec=B, num_jack=J, seed=seed,
                    geno_impute_method=impute, dtype="float64",
                    streaming=streaming)
    eng = Engine(data, spec, cfg)
    eng.run_precompute_and_assemble()
    return data, eng


def make_oracle(ds, data, model="rhe", genie_model="G", J=8, B=8, seed=7,
                impute="binary", annot=None):
    geno = load_geno_nan(ds["prefix"], N, M)
    return Oracle(
        geno, annot if annot is not None else ds["annot1"],
        data.pheno, cov=data.cov, env=data.env,
        model=model, genie_model=genie_model, num_random_vec=B, num_jack=J,
        seed=seed, geno_impute_method=impute)


@pytest.mark.parametrize("cov", [False, True])
@pytest.mark.parametrize("impute", ["binary", "mean"])
def test_rhe_single_bin(small_dataset, cov, impute):
    data, eng = run_engine(small_dataset, cov=cov, impute=impute)
    orc = make_oracle(small_dataset, data, impute=impute)
    sj_o, st_o = orc.estimate()
    sj_e, st_e = eng.estimate(0)
    np.testing.assert_allclose(eng.M_mat, orc.Mmat)
    np.testing.assert_allclose(st_e, st_o, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sj_e, sj_o, rtol=1e-7, atol=1e-9)


def test_rhe_8bin_cov(small_dataset):
    data, eng = run_engine(small_dataset, annot_key="annot8_path", cov=True)
    orc = make_oracle(small_dataset, data, annot=small_dataset["annot8"])
    sj_o, st_o = orc.estimate()
    sj_e, st_e = eng.estimate(0)
    np.testing.assert_allclose(st_e, st_o, rtol=1e-7, atol=1e-9)
    # downstream summaries
    h2_e = S.h2_nonoverlapping(np.vstack([sj_e, st_e[None]]))
    h2_o = orc.h2_nonoverlap(sj_o, st_o)
    np.testing.assert_allclose(h2_e, h2_o, rtol=1e-7, atol=1e-9)
    enr_e = S.enrichment(h2_e, eng.M_mat)
    enr_o = orc.enrichment(h2_o)
    np.testing.assert_allclose(enr_e, enr_o, rtol=1e-6, atol=1e-8)
    se_e = S.jackknife_se(sj_e, eng.J)
    se_o = orc.jackknife_se(sj_o, orc.J)
    np.testing.assert_allclose(se_e, se_o, rtol=1e-6, atol=1e-10)


def test_rhe_dom(small_dataset):
    data, eng = run_engine(small_dataset, model="rhe_dom", cov=True)
    orc = make_oracle(small_dataset, data, model="rhe_dom")
    sj_o, st_o = orc.estimate()
    sj_e, st_e = eng.estimate(0)
    np.testing.assert_allclose(st_e, st_o, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(sj_e, sj_o, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("genie_model", ["G", "G+GxE", "G+GxE+NxE"])
def test_genie(small_dataset, genie_model):
    data, eng = run_engine(small_dataset, model="genie",
                           genie_model=genie_model, cov=True, env=True)
    orc = make_oracle(small_dataset, data, model="genie",
                      genie_model=genie_model)
    sj_o, st_o = orc.estimate()
    sj_e, st_e = eng.estimate(0)
    np.testing.assert_allclose(eng.M_mat, orc.Mmat)
    np.testing.assert_allclose(st_e, st_o, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(sj_e, sj_o, rtol=1e-6, atol=1e-8)
    # trace-adjusted sigmas use the T border column (reference genie.py:128-131)
    np.testing.assert_allclose(eng.T_all[:, :, eng.E][-1],
                               orc.T_border[-1], rtol=1e-7)


def test_streaming_equals_cached(small_dataset):
    _, eng_c = run_engine(small_dataset, cov=True, streaming=False)
    _, eng_s = run_engine(small_dataset, cov=True, streaming=True)
    np.testing.assert_allclose(eng_c.T_all, eng_s.T_all, rtol=0, atol=0)
    np.testing.assert_allclose(eng_c.q_all, eng_s.q_all, rtol=0, atol=0)


def test_float32_close_to_float64(small_dataset):
    data64, eng64 = run_engine(small_dataset, cov=True)
    data = load_dataset(small_dataset["prefix"],
                        annot_file=small_dataset["annot1_path"],
                        pheno_file=small_dataset["pheno_path"],
                        cov_file=small_dataset["cov_path"],
                        num_random_vec=8, seed=7)
    cfg = RunConfig(num_random_vec=8, num_jack=8, seed=7, dtype="float32")
    eng32 = Engine(data, ModelSpec.build("rhe"), cfg)
    eng32.run_precompute_and_assemble()
    _, st64 = eng64.estimate(0)
    _, st32 = eng32.estimate(0)
    np.testing.assert_allclose(st32, st64, rtol=2e-3, atol=2e-4)


def test_rhe_overlapping_annot(small_dataset, tmp_path):
    """Multi-membership annotations end-to-end: engine estimates AND the
    overlapping-annotation h2 (solver.h2_overlapping's vectorized LOO
    overlap-count algebra, including the j==J remainder quirk) against
    the oracle's literal per-SNP membership walk (reference
    base.py:744-785)."""
    from pyrhe_tpu.io import synth

    annot_path = str(tmp_path / "overlap.annot")
    annot = synth.make_annot(annot_path, M, 4, seed=9, overlap=True)
    assert (annot.sum(axis=1) > 1).any()       # fixture really overlaps
    ds = dict(small_dataset, annot8_path=annot_path)
    data, eng = run_engine(ds, annot_key="annot8_path", cov=True)
    orc = make_oracle(ds, data, annot=annot)
    sj_o, st_o = orc.estimate()
    sj_e, st_e = eng.estimate(0)
    np.testing.assert_allclose(eng.M_mat, orc.Mmat)
    np.testing.assert_allclose(st_e, st_o, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(sj_e, sj_o, rtol=1e-6, atol=1e-8)

    h2_e = S.h2_overlapping(np.vstack([sj_e, st_e[None]]), data.annot,
                            eng.M_mat, eng.J)
    h2_o = orc.h2_overlap(sj_o, st_o)
    np.testing.assert_allclose(h2_e, h2_o, rtol=1e-7, atol=1e-10)


def test_h2_overlap_remainder_quirk(small_dataset):
    """J that does not divide M exercises the j==J annot-subsample quirk
    (the 'total' sample drops the last step+remainder SNPs)."""
    from pyrhe_tpu.io import synth

    rng = np.random.default_rng(0)
    annot = np.zeros((M, 3), dtype=np.int64)
    annot[np.arange(M), rng.integers(0, 3, M)] = 1
    annot[rng.random(M) < 0.3, 0] = 1          # heavy overlap into bin 0
    J = 7                                      # 800 % 7 = 2 remainder SNPs
    sig = rng.normal(size=(J + 1, 4)) ** 2
    M_mat = np.zeros((J + 1, 3), dtype=np.int64)
    step = M // J
    M_mat[J] = annot.sum(axis=0)
    for j in range(J):
        s, e = j * step, ((j + 1) * step if j < J - 1 else M)
        M_mat[j] = M_mat[J] - annot[s:e].sum(axis=0)

    orc = object.__new__(Oracle)               # skip __init__: no genotype
    orc.J, orc.E, orc.M_snp, orc.annot, orc.Mmat = J, 3, M, annot, M_mat
    h2_o = orc.h2_overlap(sig[:-1], sig[-1])
    h2_e = S.h2_overlapping(sig, annot, M_mat, J)
    np.testing.assert_allclose(h2_e, h2_o, rtol=1e-10, atol=1e-12)


def test_genie_multi_env(small_dataset, tmp_path):
    """num_env > 1 with the CORRECTED GxE estimate indexing
    (k_gxe = num_bin + e*num_bin + k; the reference's collides for
    num_env > 1, genie.py:65 — SURVEY 2.6)."""
    from pyrhe_tpu.io import synth

    env_path = str(tmp_path / "multi.env")
    synth.make_env_file(env_path, N, num_env=2, seed=11)
    ds = dict(small_dataset, env_path=env_path)
    data, eng = run_engine(ds, model="genie", genie_model="G+GxE+NxE",
                           cov=True, env=True)
    assert data.num_env == 2
    orc = make_oracle(ds, data, model="genie", genie_model="G+GxE+NxE")
    sj_o, st_o = orc.estimate()
    sj_e, st_e = eng.estimate(0)
    assert eng.E == 1 + 2 + 2                  # G + 2 GxE + 2 NxE
    np.testing.assert_allclose(eng.M_mat, orc.Mmat)
    np.testing.assert_allclose(st_e, st_o, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(sj_e, sj_o, rtol=1e-6, atol=1e-8)


def test_genie_multi_env_simulation_recovery(tmp_path):
    """Known-truth recovery: simulate y with DISTINCT sigma_gxe per env
    (plus per-env NxE) and assert GENIE G+GxE+NxE recovers every
    component within 2 jackknife-SE — and preserves the env ordering.

    This guards the corrected GxE estimate indexing
    (k_gxe = num_bin + e*num_bin + k, models/genie.py:5-8) against the
    reference's collision for num_env > 1
    (reference genie.py:65: (e+1)*k + num_bin), which the in-repo oracle
    cannot catch alone since both sides implement the corrected layout.
    A collision/swap would mix the two envs' very different variances.
    """
    from pyrhe_tpu.io import synth

    Nr, Mr = 3000, 2000
    truth_g, truth_gxe, truth_nxe = 0.25, (0.20, 0.05), (0.10, 0.20)
    prefix = str(tmp_path / "rec")
    synth.make_dataset(prefix, Nr, Mr, seed=21, missing_rate=0.0)
    annot = synth.make_annot(str(tmp_path / "rec.annot"), Mr, 1, seed=21)
    env = synth.make_env_file(str(tmp_path / "rec.env"), Nr, num_env=2,
                              seed=21)
    synth.simulate_pheno_file(prefix, prefix, [truth_g], annot, seed=22,
                              env=env, sigma_gxe=truth_gxe,
                              sigma_nxe=truth_nxe)

    data = load_dataset(prefix, annot_file=str(tmp_path / "rec.annot"),
                        pheno_file=prefix + ".pheno",
                        env_file=prefix + ".env",
                        num_random_vec=16, seed=5)
    spec = ModelSpec.build("genie", "G+GxE+NxE", data.num_env)
    cfg = RunConfig(num_random_vec=16, num_jack=8, seed=5, dtype="float64")
    eng = Engine(data, spec, cfg)
    eng.run_precompute_and_assemble()
    sigma_jack, sigma_total = eng.estimate(0)
    se = S.jackknife_se(sigma_jack, 8)

    resid = 1.0 - truth_g - sum(truth_gxe) - sum(truth_nxe)
    truth = np.array([truth_g, *truth_gxe, *truth_nxe, resid])
    assert sigma_total.shape == truth.shape
    # every component within 2 jackknife-SE of the simulated truth
    # (all z < 1.1 for these seeds; 2 SE leaves margin without masking
    # an index collision, which would move estimates by >> 2 SE)
    np.testing.assert_array_less(np.abs(sigma_total - truth), 2 * se)
    # distinct per-env values land in the right slots, in the right order
    assert sigma_total[1] > sigma_total[2]     # gxe: env0 (0.20) > env1 (0.05)
    assert sigma_total[4] > sigma_total[3]     # nxe: env1 (0.20) > env0 (0.10)


@pytest.mark.parametrize("mm_mode,rtol_sig,rtol_h2", [
    ("split2", 3e-4, 3e-4),     # documented ~1e-5 relative per matmul
    ("bf16", 3e-2, 2e-2),       # documented ~1e-3 relative per matmul
])
def test_mm_mode_end_to_end_envelope(small_dataset, mm_mode, rtol_sig,
                                     rtol_h2):
    """End-to-end precision gate for the reduced-precision matmul modes
    (ops/moments.py:21-28): a full estimation run (sigma AND h2) in
    mm_mode must stay inside the documented envelope of the float64
    exact run. Guards the dosage-exact bf16 insight (the genotype
    operand is integer, exact in bf16; only the probe side loses bits)
    against regressions anywhere in the pipeline, not just in the
    kernel-level parity tests.
    """
    _, eng64 = run_engine(small_dataset, cov=True)
    data = load_dataset(small_dataset["prefix"],
                        annot_file=small_dataset["annot1_path"],
                        pheno_file=small_dataset["pheno_path"],
                        cov_file=small_dataset["cov_path"],
                        num_random_vec=8, seed=7)
    cfg = RunConfig(num_random_vec=8, num_jack=8, seed=7, dtype="float32",
                    mm_mode=mm_mode)
    eng = Engine(data, ModelSpec.build("rhe"), cfg)
    eng.run_precompute_and_assemble()

    sj64, st64 = eng64.estimate(0)
    sj, st = eng.estimate(0)
    scale = np.abs(st64).max()
    np.testing.assert_allclose(st, st64, rtol=rtol_sig,
                               atol=rtol_sig * scale)

    h2_64 = S.h2_nonoverlapping(np.vstack([sj64, st64[None]]))
    h2 = S.h2_nonoverlapping(np.vstack([sj, st[None]]))
    np.testing.assert_allclose(h2[-1], h2_64[-1], rtol=rtol_h2,
                               atol=rtol_h2 * np.abs(h2_64[-1]).max())
