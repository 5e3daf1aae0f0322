"""Scalar float64 oracle implementations of the reference formulas.

Deliberately written as literal, slow per-pair loops mirroring the
reference C++ math (CalCor src/util.cpp:49-70, CalWgtCov
src/util.cpp:103-124, per-string CalCor src/util.cpp:153-169, run_dist
src/dist.cpp:129-227) so the vectorized device kernels have an independent
check.
"""

import numpy as np


def cal_cor_pooled(x: np.ndarray, y: np.ndarray) -> float:
    """Reference CalCor over concatenated population genotype strings."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    n = x.size
    sumx, sumy = x.sum(), y.sum()
    sumxsq, sumysq = (x * x).sum(), (y * y).sum()
    sumxy = (x * y).sum()
    numer = n * sumxy - sumx * sumy
    denor = np.sqrt(n * sumxsq - sumx * sumx) * np.sqrt(n * sumysq - sumy * sumy)
    return numer / denor


def cal_wgt_cov(x: np.ndarray, y: np.ndarray, pop_sizes, wgts) -> float:
    """Reference CalWgtCov: weighted covariance over population segments."""
    bounds = np.concatenate([[0], np.cumsum(pop_sizes)])
    wsumcov = wsum_mi_mj = wsum_mi = wsum_mj = 0.0
    for k, w in enumerate(wgts):
        xs = x[bounds[k]:bounds[k + 1]].astype(np.float64)
        ys = y[bounds[k]:bounds[k + 1]].astype(np.float64)
        m = xs.size
        sumx, sumy, sumxy = xs.sum(), ys.sum(), (xs * ys).sum()
        factor = m / (m - 1)
        wsumcov += w * factor * (m * sumxy - sumx * sumy)
        wsum_mi_mj += w * (sumx / m) * (sumy / m)
        wsum_mi += w * (sumx / m)
        wsum_mj += w * (sumy / m)
    return wsumcov + wsum_mi_mj - wsum_mi * wsum_mj


def cal_cor_single(x: np.ndarray, y: np.ndarray) -> float:
    """Reference per-population-string CalCor (same formula as pooled)."""
    return cal_cor_pooled(x, y)


def weighted_corr_matrix(Ga, Gb, pop_sizes, wgts):
    """Brute-force weighted correlation block."""
    na, nb = Ga.shape[0], Gb.shape[0]
    stda = np.array([np.sqrt(cal_wgt_cov(Ga[i], Ga[i], pop_sizes, wgts))
                     for i in range(na)])
    stdb = np.array([np.sqrt(cal_wgt_cov(Gb[j], Gb[j], pop_sizes, wgts))
                     for j in range(nb)])
    out = np.empty((na, nb))
    for i in range(na):
        for j in range(nb):
            out[i, j] = cal_wgt_cov(Ga[i], Gb[j], pop_sizes, wgts) / (stda[i] * stdb[j])
    return out


def pooled_corr_matrix(Ga, Gb):
    na, nb = Ga.shape[0], Gb.shape[0]
    out = np.empty((na, nb))
    for i in range(na):
        for j in range(nb):
            out[i, j] = cal_cor_pooled(Ga[i], Gb[j])
    return out


def run_qcat_oracle(B11_corr, B21_corr, Z1, headwing, num_pred_measured,
                    lam=0.1, eig_cutoff=0.01):
    """Literal translation of run_qcat (src/qcat.cpp:134-246)."""
    M = B11_corr.shape[0]
    B11 = B11_corr.copy()
    np.fill_diagonal(B11, 1.0 + lam)
    w = np.linalg.eigvalsh(B11)
    num_eig = int(np.sum(~(w < eig_cutoff)))
    L = np.linalg.cholesky(B11)
    LInv = np.linalg.inv(L)
    LInvZ1 = LInv @ Z1

    def corr(a, b):
        da, db = a - a.mean(), b - b.mean()
        return (da * db).sum() / np.sqrt((da * da).sum() * (db * db).sum())

    t_meas, c_meas = [], []
    for i in range(num_pred_measured):
        b11t = B11[i + headwing, :]
        r = corr(LInvZ1, LInv @ b11t)
        t_meas.append(np.sqrt(num_eig - 3) * r)
        c_meas.append((num_eig - 3) * r * r)
    t_un, c_un = [], []
    for i in range(B21_corr.shape[0]):
        r = corr(LInvZ1, LInv @ B21_corr[i])
        t_un.append(np.sqrt(num_eig - 3) * r)
        c_un.append((num_eig - 3) * r * r)
    return num_eig, np.array(t_meas), np.array(c_meas), \
        np.array(t_un), np.array(c_un)


def jepeg_gene_oracle(CorG_noridge, z, info, categ_wgt, categ_present,
                      lam=0.1, min_abs_eig=1e-5, cor_cutoff=0.8,
                      denorm=3):
    """Literal translation of CalJepegPval (src/gene.cpp:288-550).
    Returns (chisq, df) or (None, 0) when all categories prune away."""
    counts = categ_present.sum(axis=0)
    present = np.flatnonzero(counts > 0)
    k = len(present)
    CorG = CorG_noridge.copy()
    np.fill_diagonal(CorG, 1.0 + lam)
    W = (categ_wgt[:, present] * np.sqrt(info)[:, None]).T
    WWt = W @ W.T
    CovU = W @ CorG @ W.T
    dstd = np.sqrt(np.diag(CovU))
    CorU = CovU / np.outer(dstd, dstd)
    U = W @ z
    rmv = np.zeros(k, dtype=bool)
    for j in range(k - 1, 0, -1):
        for i in range(j):
            if abs(CorU[i, j]) > cor_cutoff:
                rmv[j] = True
                break
    for i in range(k):
        if CovU[i, i] < WWt[i, i] / denorm:
            rmv[i] = True
    df = int(k - rmv.sum())
    if df == 0:
        return None, 0
    X = U[~rmv]
    CovX = CovU[np.ix_(~rmv, ~rmv)]
    w, v = np.linalg.eigh(CovX)
    if w.min() < min_abs_eig:
        CovX = (v * np.maximum(w, min_abs_eig)) @ v.T
    return float(X @ np.linalg.inv(CovX) @ X), df


def run_dist_oracle(B11_corr, B21_corr, Z1, lam=0.1, min_abs_eig=1e-5):
    """Literal translation of run_dist's imputation loop
    (src/dist.cpp:156-210): MakePosDef + full inverse + per-SNP matvecs."""
    M = B11_corr.shape[0]
    B11 = B11_corr.copy()
    np.fill_diagonal(B11, 1.0 + lam)
    w, v = np.linalg.eigh(B11)
    if w.min() < min_abs_eig:
        w = np.maximum(w, min_abs_eig)
        B11 = (v * w) @ v.T
    B11inv = np.linalg.inv(B11)
    zs, infos = [], []
    for i in range(B21_corr.shape[0]):
        b21 = B21_corr[i]
        t = b21 @ B11inv
        z2 = t @ Z1
        info = abs(t @ b21)
        zs.append(z2 / np.sqrt(info))
        infos.append(info)
    return np.array(zs), np.array(infos)
