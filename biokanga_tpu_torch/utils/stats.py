"""Copy of biokanga_tpu/utils/stats.py (host numpy and scipy).

Statistical tests (CStats parity, libbiokanga/Stats.h:78-108).

The reference class provides Fisher's exact test, chi-square tables and
P-values, nCk/binomial PMF and CDF — used by SNP calling, DE analysis
and marker scoring. Vectorised here over numpy arrays; the SNP path's
large-batch binomial runs through the same scipy kernels that
align/snp.py uses on device-shaped arrays.
"""
from __future__ import annotations

import numpy as np
from scipy import stats as _sps
from scipy.special import gammaln as _gammaln


def fishers_exact_test(r1c1: int, r1c2: int, r2c1: int, r2c2: int) -> float:
    """One-sided Fisher's exact P (CStats::FishersExactTest returns P1,
    Stats.h:90-94): probability of a table at least as extreme in the
    direction of enrichment of R1C1."""
    table = [[r1c1, r1c2], [r2c1, r2c2]]
    return float(_sps.fisher_exact(table, alternative="greater")[1])


def chisqr_pval(df: int, chisqr: float) -> float:
    """P-value of a chi-square statistic (CStats::ChiSqr2PVal)."""
    if chisqr < 0:
        return 1.0
    return float(_sps.chi2.sf(chisqr, df))


def calc_chisqr(cells: np.ndarray) -> float:
    """Pearson chi-square over an observed-count table
    (CStats::CalcChiSqr, Stats.h:98-101): returns -1.0 if any expected
    count is below 5, matching the reference's validity guard."""
    obs = np.asarray(cells, dtype=np.float64)
    total = obs.sum()
    if total <= 0:
        return -1.0
    exp = (obs.sum(axis=1, keepdims=True)
           * obs.sum(axis=0, keepdims=True)) / total
    if (exp < 5.0).any():
        return -1.0
    return float(((obs - exp) ** 2 / exp).sum())


def calc_nck(n: int, k: int) -> float:
    """nCk via log-gamma (CStats::Calc_nCk)."""
    if k < 0 or k > n:
        return 0.0
    return float(np.exp(_gammaln(n + 1) - _gammaln(k + 1)
                        - _gammaln(n - k + 1)))


def prob_k_eql_k(n: int, k: int, p: float) -> float:
    """Binomial PMF Pr(K == k) (CStats::ProbKeqlk)."""
    return float(_sps.binom.pmf(k, n, p))


def binomial(n, k, p):
    """Cumulative binomial Pr(K <= k) (CStats::Binomial, Stats.h:107)
    — accepts scalars or arrays (the SNP caller path evaluates this
    over whole pileup batches at once)."""
    return _sps.binom.cdf(k, n, p)


def benjamini_hochberg(pvals: np.ndarray) -> np.ndarray:
    """BH FDR adjustment (the aligner's SNP AdjPValue = rank/N * QValue
    inversion, biokanga/Aligner.cpp:7122) — returns adjusted q-values
    in the original order."""
    p = np.asarray(pvals, dtype=np.float64)
    n = p.size
    order = np.argsort(p)
    ranked = p[order] * n / (np.arange(n) + 1)
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.clip(ranked, 0.0, 1.0)
    return out
