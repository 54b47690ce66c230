"""Feature-level tests: XtXz export, simulate_pheno, liability, trace files."""
import os

import numpy as np
import pytest

from conftest import load_geno_nan

from pyrhe_tpu.core import solver as S
from pyrhe_tpu.models import RHE

N, M = 600, 800


def make_model(ds, tmp, **kw):
    return RHE(geno_file=ds["prefix"], annot_file=ds["annot1_path"],
               pheno_file=ds["pheno_path"], num_jack=kw.pop("num_jack", 4),
               num_random_vec=kw.pop("num_random_vec", 4), seed=kw.pop(
                   "seed", 7), dtype="float64", **kw)


def test_get_XtXz_matches_numpy(small_dataset, tmp_path):
    rhe = make_model(small_dataset, tmp_path)
    out = str(tmp_path / "xtxz")
    results = rhe.get_XtXz(out, jackknife_blocks=True)

    # independent numpy computation on imputed dosages
    geno = load_geno_nan(small_dataset["prefix"], N, M)  # (N, M) w/ nan
    eng = rhe.engine
    G = np.zeros_like(geno)
    for j in range(eng.J):
        s, e = eng._block_range(j)
        gj = np.asarray(list(eng._iter_raw_blocks())[j], np.float64).T
        G[:, s:e] = gj
    B = eng.B
    Xz = np.zeros((N, B))
    Zs = {}
    for j in range(eng.J):
        s, e = eng._block_range(j)
        Zs[j] = np.random.default_rng([7, j]).normal(size=(e - s, B))
        Xz += G[:, s:e] @ Zs[j]
    expect = G.T @ Xz
    np.testing.assert_allclose(results, expect, rtol=1e-8, atol=1e-8)

    # binary files exist and round-trip
    loaded = np.fromfile(out + ".txt.bin").reshape(M, B)
    np.testing.assert_allclose(loaded, results)
    jk0 = np.fromfile(out + ".jack_0.txt.bin").reshape(-1, B)
    s, e = eng._block_range(0)
    Xz_loo = Xz - G[:, s:e] @ Zs[0]
    expect_jk0 = np.delete(G.T @ Xz_loo, np.s_[s:e], axis=0)
    np.testing.assert_allclose(jk0, expect_jk0, rtol=1e-7, atol=1e-7)


def test_simulate_pheno_recovers_h2(small_dataset, tmp_path):
    rhe = make_model(small_dataset, tmp_path, num_jack=8,
                     num_random_vec=16, seed=3)
    y, betas = rhe.simulate_pheno([0.5])
    assert y.shape == (N,)
    assert abs(rhe.data.pheno.mean()) < 1e-9
    sigma_jack, sigma_total = rhe.estimate(0)
    h2 = S.h2_nonoverlapping(np.vstack([sigma_jack, sigma_total[None]]))
    se = S.jackknife_se(h2[:-1], 8)
    # unstandardized-X simulation: realized genetic variance is
    # sum_c beta_c^2 * var(x_c); check recovery within ~4 SE of that
    geno = load_geno_nan(small_dataset["prefix"], N, M)
    eng = rhe.engine
    G = np.concatenate([np.asarray(g, np.float64).T
                        for g in eng._iter_raw_blocks()], axis=1)
    gvar = ((G - G.mean(0)) @ betas).var()
    truth = gvar / (gvar + (1 - 0.5))
    assert abs(h2[-1, -1] - truth) < 4 * max(se[-1], 0.05)


def test_liability_h2_values():
    # spot-check against the published formula (reference base.py:857-868)
    h2_liab, se_liab, p = S.liability_h2(0.2, 0.05, pop_prev=0.1,
                                         samp_prev=0.3)
    from scipy.stats import norm, chi2
    zv = norm.pdf(norm.ppf(0.1))
    scale = 0.1 ** 2 * 0.9 ** 2 / 0.3 / 0.7 / zv ** 2
    assert h2_liab == pytest.approx(0.2 * scale)
    assert se_liab == pytest.approx(0.05 * scale)
    assert p == pytest.approx(chi2.sf((0.2 * scale) ** 2 /
                                      (0.05 * scale) ** 2, 1))


def test_trace_file_contents(small_dataset, tmp_path):
    rhe = make_model(small_dataset, tmp_path, get_trace=True,
                     trace_dir=str(tmp_path))
    os.chdir(tmp_path)
    rhe(trait=0)
    base = f"run_{os.path.basename(small_dataset['pheno_path'])}"
    mn = (tmp_path / (base + ".MN")).read_text().splitlines()
    assert mn[0] == "NSAMPLE,NSNPS,NBLKS,NBINS,K"
    assert mn[1] == f"{N},{M},4,1,4"
    tr = (tmp_path / (base + ".tr")).read_text().splitlines()
    assert tr[0] == "LD_SUM_0,NSNPS_JACKKNIFE"
    assert len(tr) == 1 + (4 + 1) * 1
    # rows are lsum(T[j,0,0]) and LOO SNP counts
    eng = rhe.engine
    for j in range(5):
        val, cnt = tr[1 + j].split(",")
        expect = S.calc_lsum(eng.T_all[j, 0, 0], N, eng.M_mat[j, 0],
                             eng.M_mat[j, 0])
        assert float(val) == pytest.approx(expect, abs=0.5e-3)
        assert int(cnt) == eng.M_mat[j, 0]


def test_genie_trace_writes_full_component_block(small_dataset, tmp_path):
    """GENIE trace export: the SUMRHE `.tr` keeps only the K genetic bins
    (format limitation), so the full (E, E) block — G + GxE + NxE rows the
    engine computes — must land in `.all.tr` instead of being silently
    dropped."""
    from pyrhe_tpu.models import GENIE

    genie = GENIE(geno_file=small_dataset["prefix"],
                  annot_file=small_dataset["annot1_path"],
                  pheno_file=small_dataset["pheno_path"],
                  env_file=small_dataset["env_path"],
                  genie_model="G+GxE+NxE", num_jack=4, num_random_vec=4,
                  seed=7, dtype="float64", get_trace=True,
                  trace_dir=str(tmp_path))
    os.chdir(tmp_path)
    genie(trait=0)
    base = f"run_{os.path.basename(small_dataset['pheno_path'])}"
    eng = genie.engine
    E = eng.E
    assert E == 3   # 1 genetic bin + 1 GxE + 1 NxE

    tr = (tmp_path / (base + ".tr")).read_text().splitlines()
    assert tr[0] == "LD_SUM_0,NSNPS_JACKKNIFE"   # SUMRHE: K=1 columns

    full = (tmp_path / (base + ".all.tr")).read_text().splitlines()
    assert full[0] == ",".join(f"LD_SUM_{i}" for i in range(E)) + \
        ",NSNPS_JACKKNIFE"
    assert len(full) == 1 + (4 + 1) * E
    # spot-check a GxE row against the engine's trace sums
    row = full[1 + 1].split(",")   # j=0, component k=1 (GxE)
    assert len(row) == E + 1
    assert float(row[1]) == pytest.approx(eng.trace_sums[0, 1, 1],
                                          abs=0.5e-3)
    assert int(row[E]) == eng.M_mat[0, 1]


def test_fast_synth_dataset(tmp_path):
    """make_dataset_fast writes a valid one-pass dataset whose estimates
    recover the generative sigma (native generator when available, NumPy
    fallback otherwise — both behind the same interface)."""
    from pyrhe_tpu.core.data import load_dataset
    from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig
    from pyrhe_tpu.io import synth
    from pyrhe_tpu.io.bed import BedFile, synth_packed_block

    prefix = str(tmp_path / "fast")
    mafs, annot, y = synth.make_dataset_fast(prefix, 1500, 4000, [0.5],
                                             seed=5, missing_rate=0.02)
    assert annot.shape == (4000, 1) and y.shape == (1500,)

    bed = BedFile(prefix + ".bed", 1500, 4000)
    g = bed.read_block(0, 400)
    miss = g == 255
    assert 0.01 < miss.mean() < 0.03
    emp_maf = np.where(miss, 0, g).sum(axis=1) / (2.0 * (~miss).sum(axis=1))
    assert np.corrcoef(emp_maf, mafs[:400])[0, 1] > 0.99

    # the native generator is deterministic in (seed, snp offset): any
    # block range reproduces the same bytes
    a = synth_packed_block(5, 0, 64, 1500, mafs[:64], 0.02)
    if a is not None:
        b = synth_packed_block(5, 32, 32, 1500, mafs[32:64], 0.02)
        assert np.array_equal(a[32:], b)

    data = load_dataset(prefix, annot_file=prefix + ".annot",
                        pheno_file=prefix + ".pheno", num_random_vec=10,
                        seed=1)
    eng = Engine(data, ModelSpec.build("rhe"),
                 RunConfig(num_random_vec=10, num_jack=10, seed=1))
    eng.precompute()
    eng.assemble()
    _, st = eng.estimate(0)
    assert abs(st[0] - 0.5) < 0.15


def _truncate_lines(src, dst, drop=2, keep_header=False):
    with open(src) as f:
        lines = f.readlines()
    with open(dst, "w") as f:
        f.writelines(lines[:len(lines) - drop])
    return dst


def test_input_geometry_validation(small_dataset, tmp_path):
    """Mismatched side-file geometry must raise a ValueError naming BOTH
    files at load time, not a broadcast error deep in the engine
    (the reference has no such guard)."""
    from pyrhe_tpu.core.data import load_dataset

    ds = small_dataset
    ok = dict(geno_file=ds["prefix"], annot_file=ds["annot1_path"],
              pheno_file=ds["pheno_path"], cov_file=ds["cov_path"],
              env_file=ds["env_path"], num_random_vec=4, seed=7)
    load_dataset(**ok)   # sanity: the untruncated combination loads

    bad_annot = _truncate_lines(ds["annot1_path"],
                                str(tmp_path / "short.annot"))
    with pytest.raises(ValueError, match=r"short\.annot.*\.bim"):
        load_dataset(**{**ok, "annot_file": bad_annot})

    bad_pheno = _truncate_lines(ds["pheno_path"],
                                str(tmp_path / "short.pheno"))
    with pytest.raises(ValueError, match=r"short\.pheno.*\.fam"):
        load_dataset(**{**ok, "pheno_file": bad_pheno})

    bad_cov = _truncate_lines(ds["cov_path"], str(tmp_path / "short.cov"))
    with pytest.raises(ValueError, match=r"short\.cov.*\.fam"):
        load_dataset(**{**ok, "cov_file": bad_cov})

    bad_env = _truncate_lines(ds["env_path"], str(tmp_path / "short.env"))
    with pytest.raises(ValueError, match=r"short\.env.*\.fam"):
        load_dataset(**{**ok, "env_file": bad_env})


def test_report_flags_non_finite(small_dataset, tmp_path):
    """A NaN sigma/SE/h2 must surface as a loud report WARNING naming the
    offending keys, never ride the regex-parsed output silently."""
    rhe = make_model(small_dataset, tmp_path)
    rhe._check_finite({"sigma_ests_total": np.array([0.4, 0.6]),
                       "h2_errs": [0.1, np.nan],
                       "enrichment_total": np.array([np.inf])})
    warn = [m for m in rhe.log.msgs if "non-finite" in m]
    assert len(warn) == 1
    assert "enrichment_total, h2_errs" in warn[0]
    assert "sigma_ests_total" not in warn[0]

    res = rhe(trait=0)   # a real healthy run must NOT warn
    assert all(np.all(np.isfinite(np.asarray(v, np.float64)))
               for v in res.values())
    assert len([m for m in rhe.log.msgs if "non-finite" in m]) == 1


def test_pallas_downgrade_note_on_accelerator(small_dataset, tmp_path):
    """packed_scan="auto" puts an accelerator on the chunked packed-byte
    scan whatever the precision mode (exact float32 included), while a
    CPU run keeps the per-block reference path; neither is a downgrade,
    so nothing is logged as one."""
    from pyrhe_tpu.utils.logger import Logger

    rhe = make_model(small_dataset, tmp_path)
    eng = rhe.engine
    assert not eng.packed_scan and eng.N_work == eng.data.num_indv
    assert not any("DISABLED" in m for m in rhe.log.msgs)

    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    eng._dev = FakeGpu()
    eng.mm_mode = "exact"
    eng.log = Logger(suppress=True, debug_mode=False)
    eng._setup_layout()
    assert eng.packed_scan
    assert eng.N_work == eng.data.bed.num_indiv
    assert not any("DISABLED" in m for m in eng.log.msgs)


@pytest.mark.filterwarnings("error::RuntimeWarning")
def test_multi_trait_matches_independent_single_trait(small_dataset,
                                                      tmp_path):
    """Value-level multi-trait correctness: in the shared-
    precompute design every trait rides the same probe matrix (engine.py
    module docstring), so trait t of a T-trait run must reproduce an
    independent run on that trait's column alone — same seed, same
    estimates. The reference reruns everything per trait
    (base.py:874-886); this pins our redesign to that semantics."""
    from pyrhe_tpu.io import synth

    pheno2 = str(tmp_path / "multi")
    synth.simulate_pheno_file(pheno2, small_dataset["prefix"], [0.3],
                              small_dataset["annot1"], seed=9, num_traits=2)
    # split trait 1 into its own file (FID IID t1)
    single = str(tmp_path / "single.pheno")
    with open(pheno2 + ".pheno") as f, open(single, "w") as g:
        hdr = f.readline().split()
        g.write(f"{hdr[0]} {hdr[1]} {hdr[3]}\n")
        for line in f:
            p = line.split()
            g.write(f"{p[0]} {p[1]} {p[3]}\n")

    multi = make_model(dict(small_dataset, pheno_path=pheno2 + ".pheno"),
                       tmp_path, cov_file=small_dataset["cov_path"])
    multi.engine.run_precompute_and_assemble()
    sj_m, st_m = multi.engine.estimate(1)
    se_m = S.jackknife_se(sj_m, sj_m.shape[0])

    solo = make_model(dict(small_dataset, pheno_path=single), tmp_path,
                      cov_file=small_dataset["cov_path"])
    solo.engine.run_precompute_and_assemble()
    sj_s, st_s = solo.engine.estimate(0)
    se_s = S.jackknife_se(sj_s, sj_s.shape[0])

    np.testing.assert_allclose(st_m, st_s, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(sj_m, sj_s, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(se_m, se_s, rtol=1e-8, atol=1e-12)


def test_streaming_host_cache_skips_reread(small_dataset):
    """The host-RAM packed cache must make streaming pass 2 restage from
    memory — no second .bed read — and be bit-identical to the cache-off
    run (the reference's streaming mode re-reads every block from disk,
    base_streaming.py:116-118)."""
    from pyrhe_tpu.core.data import load_dataset
    from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig

    def mk(cache_gb):
        data = load_dataset(small_dataset["prefix"],
                            annot_file=small_dataset["annot1_path"],
                            pheno_file=small_dataset["pheno_path"],
                            num_random_vec=4, seed=7)
        spec = ModelSpec.build("rhe", "G", data.num_env)
        cfg = RunConfig(num_random_vec=4, num_jack=6, seed=7,
                        dtype="float64", streaming=True,
                        host_cache_gb=cache_gb)
        return Engine(data, spec, cfg)

    off = mk(0)
    assert off._packed_cache is None
    off.run_precompute_and_assemble()

    on = mk(-1)
    assert on._packed_cache is not None, "tiny dataset must fit the cache"
    calls = []
    orig = on._load_block_uncached

    def spy(j, raw=False):
        calls.append(j)
        return orig(j, raw)

    on._load_block_uncached = spy
    on.run_precompute_and_assemble()
    # pass 1 reads each block once; pass 2 must hit the cache only
    assert len(calls) == on.J, f"expected {on.J} disk reads, got {calls}"
    assert on.phase_times.get("host_cache_hits", 0) == on.J
    np.testing.assert_array_equal(on.T_all, off.T_all)
    np.testing.assert_array_equal(on.q_all, off.q_all)


def _budget_engine(small_dataset):
    from pyrhe_tpu.core.data import load_dataset
    from pyrhe_tpu.core.engine import Engine, ModelSpec, RunConfig

    data = load_dataset(small_dataset["prefix"],
                        annot_file=small_dataset["annot1_path"],
                        pheno_file=small_dataset["pheno_path"],
                        num_random_vec=4, seed=7)
    return Engine(data, ModelSpec.build("rhe", "G", 0),
                  RunConfig(num_random_vec=4, num_jack=4, seed=7))


def test_hbm_budget_env_override(small_dataset, monkeypatch):
    """The stats-cache budget is half the device memory the runtime
    reports (bytes_limit), with no environment override."""
    eng = _budget_engine(small_dataset)

    class FakeDev:
        platform = "gpu"

        def memory_stats(self):
            return {"bytes_limit": 60e9, "bytes_in_use": 1e9}

    monkeypatch.setattr(eng, "_dev", FakeDev())
    assert eng._hbm_budget() == 30e9


def test_hbm_budget_device_kind_fallback(small_dataset, monkeypatch):
    """An accelerator that reports no memory stats is an error — the
    budget is never guessed from the device kind."""
    eng = _budget_engine(small_dataset)

    class FakeDev:
        device_kind = "NVIDIA H100 80GB HBM3"
        platform = "gpu"

        def memory_stats(self):
            return None

    monkeypatch.setattr(eng, "_dev", FakeDev())
    with pytest.raises(RuntimeError, match="no memory limit"):
        eng._hbm_budget()
