"""Tabular readers without pandas: parity with the pandas-based parsing
the reference uses (file_processing.py), on the example files and on
files with NA / -9 / non-numeric entries. The pandas implementation lives
here only as the oracle."""
import os

import numpy as np
import pytest

from pyrhe_tpu.io import readers, synth

pd = pytest.importorskip("pandas")


def oracle_read_cov(filename, std=False, missing_indvs=None,
                    cov_impute_method="ignore", one_hot_conversion=False,
                    categorical_threshold=100, one_hot_dir=None):
    df = pd.read_csv(filename, sep=r"\s+")
    missing_indvs = list(missing_indvs) if missing_indvs else []
    if missing_indvs:
        df = df.drop(index=missing_indvs, errors="ignore")
    for col in ("FID", "IID"):
        if col in df.columns:
            df = df.drop(col, axis=1)
    num = df.apply(pd.to_numeric, errors="coerce")
    is_missing = num.isna().any(axis=1) | (num == -9).any(axis=1)
    newly_missing = df.index[is_missing].tolist()
    if cov_impute_method == "ignore":
        df = num[~is_missing]
    else:
        num = num.mask(num == -9)
        df = num.fillna(num.mean())
        newly_missing = []
    one_hot = {}
    if one_hot_conversion:
        for column in df.columns:
            if df[column].nunique() <= categorical_threshold:
                one_hot[f"{column}_one_hot.cov"] = pd.get_dummies(
                    df[column], prefix=column).astype(int).to_numpy()
    if std:
        df = (df - df.mean()) / df.std(ddof=1)
    return df.values.astype(np.float64), missing_indvs + newly_missing, \
        one_hot


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("readers")
    n = 300
    synth.make_cov_file(str(d / "test.cov"), n, num_cov=5, seed=42)
    synth.make_env_file(str(d / "test.env"), n, num_env=2, seed=42)
    rng = np.random.default_rng(0)
    rows = ["FID IID age site score"]
    for i in range(40):
        age = ("NA" if i in (3, 17) else "-9" if i == 21
               else f"{rng.normal(50, 10):.4f}")
        site = "x1" if i == 30 else str(int(rng.integers(0, 3)))
        score = "nan" if i == 8 else f"{rng.normal():.6g}"
        rows.append(f"{i} 1 {age} {site} {score}")
    (d / "messy.cov").write_text("\n".join(rows) + "\n")
    return d


@pytest.mark.parametrize("name,kw", [
    ("test.cov", {}),
    ("test.cov", {"std": True}),
    ("test.cov", {"missing_indvs": [0, 5, 299]}),
    ("messy.cov", {}),
    ("messy.cov", {"cov_impute_method": "mean"}),
    ("messy.cov", {"cov_impute_method": "mean", "std": True,
                   "missing_indvs": [1, 2]}),
    ("messy.cov", {"missing_indvs": [3, 39]}),
])
def test_read_cov_matches_pandas(files, name, kw):
    got, got_missing = readers.read_cov(str(files / name), **kw)
    want, want_missing, _ = oracle_read_cov(str(files / name), **kw)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert got_missing == want_missing


@pytest.mark.parametrize("name,threshold", [("test.cov", 100),
                                            ("messy.cov", 3)])
def test_one_hot_side_files_match_pandas(files, tmp_path, name, threshold):
    readers.read_cov(str(files / name), one_hot_conversion=True,
                     categorical_threshold=threshold,
                     one_hot_dir=str(tmp_path))
    _, _, want = oracle_read_cov(str(files / name), one_hot_conversion=True,
                                 categorical_threshold=threshold)
    assert sorted(os.listdir(tmp_path)) == sorted(want)
    for fname, arr in want.items():
        got = np.loadtxt(tmp_path / fname, dtype=np.int64, ndmin=2)
        np.testing.assert_array_equal(got, arr)


def test_read_env_and_fam_match_pandas(files):
    num_env, env = readers.read_env_file(str(files / "test.env"))
    df = pd.read_csv(str(files / "test.env"), sep=r"\s+").drop(
        columns=["FID", "IID"])
    assert num_env == 2
    np.testing.assert_array_equal(env, df.to_numpy(dtype=np.float64))

    fam = files / "x.fam"
    fam.write_text("".join(f"f{i} {i} 0 0 0 -9\n" for i in range(7)))
    n, rows = readers.read_fam(str(fam))
    assert n == pd.read_csv(str(fam), sep=r"\s+", header=None).shape[0]
    assert rows[3][:2] == ["f3", "3"]
