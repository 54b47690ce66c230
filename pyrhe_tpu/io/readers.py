"""Tabular genetics file readers (.bim/.fam/annot/pheno/cov/env).

Behavioral spec: reference pyrhe/src/util/file_processing.py. Each reader
reproduces the reference's missing-data semantics (NA / -9 handling, binary
phenotype detection, FID/IID dropping, categorical one-hot side files) with
NumPy and the standard library alone.
"""
from __future__ import annotations

import math

import numpy as np

# Tokens read as missing (NaN): the NA spellings of pandas.read_csv, which
# the reference parses these files with.
NA_TOKENS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def _to_float(tok: str, coerce: bool) -> float:
    """One whitespace-separated field as float64: NA spellings are NaN;
    anything else non-numeric is NaN when coerce, else an error."""
    if tok in NA_TOKENS:
        return math.nan
    try:
        return float(tok)
    except ValueError:
        if coerce:
            return math.nan
        raise


def _read_table(filename: str, coerce: bool = False):
    """Header line + body of a whitespace-separated table. Returns
    (column names, float64 (rows, cols) array); short rows pad with NaN.
    FID/IID columns are dropped."""
    with open(filename, "r") as f:
        rows = [ln.split() for ln in f if ln.strip()]
    header, body = rows[0], rows[1:]
    keep = [i for i, c in enumerate(header) if c not in ("FID", "IID")]
    out = np.full((len(body), len(keep)), np.nan)
    for r, cols in enumerate(body):
        for k, i in enumerate(keep):
            if i < len(cols):
                out[r, k] = _to_float(cols[i], coerce)
    return [header[i] for i in keep], out


def read_bim(filename: str) -> int:
    """Count SNPs in a .bim file.

    Exact parity with reference file_processing.py:6-23, which counts
    EVERY line — including comments and blank lines (its `continue`
    skips nothing: the counter was already incremented). M drives the
    .bed decode geometry, so a silently inflated count would corrupt
    every downstream genotype; we keep the reference's count but warn
    loudly when non-data lines inflate it.
    """
    total = data = 0
    with open(filename, "r") as f:
        for line in f:
            total += 1
            if line.strip() and not line.startswith("#"):
                data += 1
    if data != total:
        import warnings
        warnings.warn(
            f"{filename}: {total - data} blank/comment line(s) counted as "
            f"SNPs (M={total}) for parity with the reference's read_bim; "
            f"if the .bed actually holds {data} SNPs the decode geometry "
            f"will be wrong — clean the .bim", stacklevel=2)
    return total


def read_fam(filename: str):
    """Return (num_individuals, rows of whitespace-split fields).
    Reference file_processing.py:25-35."""
    with open(filename, "r") as f:
        rows = [ln.split() for ln in f if ln.strip()]
    return len(rows), rows


def read_annot(filename: str, num_jack: int | None = None):
    """Read an M x K 0/1 annotation matrix.

    Returns (num_bin, annot_matrix int8 (M,K), len_bin int64 (K,)).
    Reference file_processing.py:37-69 (num_jack arg unused there too).
    """
    annot = np.loadtxt(filename, dtype=np.int64, comments="#", ndmin=2)
    len_bin = annot.sum(axis=0).astype(np.int64)
    return annot.shape[1], annot, len_bin


def generate_annot(filename: str, num_snp: int, num_bin: int, rng=None) -> None:
    """Write a random one-hot annotation file (reference file_processing.py:109-118).

    Uses the provided RNG (or the global legacy np.random state like the
    reference, which calls np.random.randint per SNP).
    """
    randint = rng.randint if rng is not None else np.random.randint
    with open(filename, "w") as f:
        for _ in range(num_snp):
            row = [0] * num_bin
            row[randint(0, num_bin)] = 1
            f.write(" ".join(str(v) for v in row) + "\n")


def read_pheno(filename: str):
    """Read a `FID IID p1..pT` phenotype file.

    Returns (y float64 (N,T) with -9 rows for missing individuals,
    missing_indv row-index list, binary flag). An individual is missing if
    ANY trait is NA or -9 (reference file_processing.py:72-107). The binary
    flag is True when every observed value is in {0,1,2}.
    """
    with open(filename, "r") as f:
        lines = f.readlines()
    header = lines[0].strip().split()
    num_ph = len(header) - 2

    y = []
    missing_indv = []
    all_binary = True
    valid_values = {0.0, 1.0, 2.0}
    for i, line in enumerate(lines[1:]):
        cols = line.strip().split()
        vals_raw = cols[2:]
        is_missing = False
        vals = []
        for v in vals_raw:
            if v == "NA":
                is_missing = True
                break
            fv = float(v)
            if fv == -9:
                is_missing = True
                break
            vals.append(fv)
        if is_missing:
            y.append([-9.0] * num_ph)
            missing_indv.append(i)
        else:
            y.append(vals)
            if not all(v in valid_values for v in vals):
                all_binary = False
    return np.array(y, dtype=np.float64), missing_indv, all_binary


def read_cov(
    filename: str,
    std: bool = False,
    missing_indvs: list | None = None,
    cov_impute_method: str = "ignore",
    one_hot_conversion: bool = False,
    categorical_threshold: int = 100,
    logger=None,
    one_hot_dir: str | None = None,
):
    """Read a covariate file, dropping FID/IID columns.

    Semantics (reference file_processing.py:121-209):
      - rows already missing (from the phenotype) are dropped first
      - a row is newly-missing if any covariate is NaN or -9
      - "ignore": drop newly-missing rows; "mean": impute with column mean
      - with one_hot_conversion, categorical columns (nunique <= threshold)
        are written to `<col>_one_hot.cov` side files; like the reference,
        the RETURNED matrix is the raw (non-one-hot) values.
    Returns (cov matrix float64 (N_kept, C), all_missing_indvs).
    """
    import os

    from ..utils.types import CovImputeMethod
    CovImputeMethod(cov_impute_method)  # raises on unknown value

    names, num = _read_table(filename, coerce=True)
    missing_indvs = list(missing_indvs) if missing_indvs else []
    rows = np.arange(num.shape[0])
    if missing_indvs:
        keep = ~np.isin(rows, missing_indvs)
        rows, num = rows[keep], num[keep]

    is_missing = np.isnan(num).any(axis=1) | (num == -9).any(axis=1)
    newly_missing = rows[is_missing].tolist()

    if cov_impute_method == "ignore":
        num = num[~is_missing]
    else:  # mean imputation over each column's observed values
        num = np.where(num == -9, np.nan, num)
        num = np.where(np.isnan(num), np.nanmean(num, axis=0), num)
        newly_missing = []

    all_missing = missing_indvs + newly_missing

    if one_hot_conversion:
        for c, column in enumerate(names):
            vals = num[:, c]
            levels = np.unique(vals[~np.isnan(vals)])
            if len(levels) <= categorical_threshold:
                if logger:
                    logger._debug(
                        f"Column '{column}' detected as categorical with {len(levels)} unique values."
                    )
                one_hot = (vals[:, None] == levels[None, :]).astype(int)
                out_name = f"{column}_one_hot.cov"
                if one_hot_dir is not None:
                    out_name = os.path.join(one_hot_dir, out_name)
                np.savetxt(out_name, one_hot, fmt="%d", delimiter=" ")
                if logger:
                    logger._debug(
                        f"One-hot encoded values for '{column}' stored in '{out_name}'"
                    )

    if std:
        num = (num - num.mean(axis=0)) / num.std(axis=0, ddof=1)

    return num.astype(np.float64), all_missing


def read_env_file(file_path: str):
    """Read environment columns (everything but FID/IID).

    Returns (num_env, env float64 (N, num_env)). The reference
    (file_processing.py:212-227) computes num_env = ncols-2 but only ever
    reads the single column named 'env'; we read all env columns so
    num_env > 1 actually works — identical behavior for the tested
    num_env == 1 case.
    """
    _, env = _read_table(file_path)
    return env.shape[1], env
