"""QCAT causality tests and preparation exports.

JAX rebuild of:
* qcat     (reference: src/qcat.cpp:30-262)
* qcatmix  (reference: src/qcatmix.cpp:30-286)
* prep_qcat (reference: src/prep_qcat.cpp:29-205)
* prep_recessive_impute (reference: src/prep_qcatmix.cpp:36-303)

The per-SNP decorrelate-and-correlate loops become batched triangular
solves: X = L^-1 B11^T (all measured columns at once) and
Y = L^-1 B21^T, then a vectorized Pearson correlation of columns
against L^-1 Z1.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pandas as pd
from scipy.linalg import solve_triangular

from ..config import PanelFiles, Settings, DEFAULT_SETTINGS
from ..core import ldkernels, linalg
from ..io import readers
from ..ops import dosage
from ..utils.special import pchisq_upper
from . import pipeline


def _column_corr_with(v: np.ndarray, X: np.ndarray) -> np.ndarray:
    """Pearson correlation of vector v with each column of X (reference:
    CalCor on Eigen vectors, src/util.cpp:194-203)."""
    dv = v - v.mean()
    dX = X - X.mean(axis=0, keepdims=True)
    num = dv @ dX
    den = np.sqrt((dv * dv).sum() * (dX * dX).sum(axis=0))
    return num / den


def _qcat_core(B11: np.ndarray, B21: np.ndarray, Z1: np.ndarray,
               pred_measured_pos: np.ndarray, settings: Settings):
    """Shared qcat math (reference: src/qcat.cpp:202-246).

    B11 carries the ridge diagonal 1+lambda.  Returns
    (num_eig, t_measured, chisq_measured, t_unmeasured, chisq_unmeasured).
    """
    num_eig = linalg.count_pc(B11, settings.eig_cutoff)
    L = linalg.cholesky_lower(B11)
    # LInv @ x == solve_triangular(L, x); the reference inverts L
    # explicitly (InvMat on the triangular factor) -- same result.
    LinvZ1 = solve_triangular(L, Z1, lower=True)

    scale = np.sqrt(num_eig - 3)
    out = {}
    if len(pred_measured_pos):
        Xm = solve_triangular(L, B11[pred_measured_pos, :].T, lower=True)
        r = _column_corr_with(LinvZ1, Xm)
        out["t_meas"] = scale * r
        out["chisq_meas"] = (num_eig - 3) * r * r
    else:
        out["t_meas"] = np.empty(0)
        out["chisq_meas"] = np.empty(0)
    if B21.shape[0]:
        Xu = solve_triangular(L, B21.T, lower=True)
        r = _column_corr_with(LinvZ1, Xu)
        out["t_unmeas"] = scale * r
        out["chisq_unmeas"] = (num_eig - 3) * r * r
    else:
        out["t_unmeas"] = np.empty(0)
        out["chisq_unmeas"] = np.empty(0)
    return num_eig, out


def _qcat_assemble(win, start_bp, end_bp, af_col, m_rows, u_rows,
                   num_eig, res) -> pd.DataFrame:
    t = win.table
    n = len(t)
    qcat_m = np.zeros(n, dtype=np.int64)
    qcat_t = np.zeros(n)
    qcat_chisq = np.zeros(n)

    bp = t["bp"].to_numpy()
    pred_meas_mask = (bp[m_rows] >= start_bp) & (bp[m_rows] <= end_bp)
    pm_rows = m_rows[pred_meas_mask]
    qcat_m[pm_rows] = num_eig
    qcat_t[pm_rows] = res["t_meas"]
    qcat_chisq[pm_rows] = res["chisq_meas"]
    qcat_m[u_rows] = num_eig
    qcat_t[u_rows] = res["t_unmeas"]
    qcat_chisq[u_rows] = res["chisq_unmeas"]

    mask = (bp >= start_bp) & (bp <= end_bp)
    tt = t[mask]
    sel = np.flatnonzero(mask)
    return pd.DataFrame({
        "rsid": tt["rsid"].to_numpy(),
        "chr": tt["chr"].to_numpy(),
        "bp": tt["bp"].to_numpy(),
        "a1": tt["a1"].to_numpy(),
        "a2": tt["a2"].to_numpy(),
        af_col: tt[af_col].to_numpy(),
        "z": tt["z"].to_numpy(),
        "qcat_m": qcat_m[sel],
        "qcat_t": qcat_t[sel],
        "qcat_chisq": qcat_chisq[sel],
        "qcat_pval": pchisq_upper(qcat_chisq[sel], 1),
        "type": tt["type"].to_numpy(),
    })


def qcat(
    chrom: int,
    start_bp: int,
    end_bp: int,
    wing_size: int,
    study_pop: str,
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> pd.DataFrame:
    """Homogeneous-cohort causality test (reference: src/qcat.cpp).
    NOTE the default af1_cutoff here is 0.05, not 0.01
    (src/qcat.cpp:52-56)."""
    if af1_cutoff is None:
        af1_cutoff = 0.05
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    inp = readers.read_input_z(input_file, chrom=chrom, start_bp=start_bp,
                               end_bp=end_bp, wing_size=wing_size)
    win = pipeline.load_window(
        panel, inp, chrom=chrom, start_bp=start_bp, end_bp=end_bp,
        wing_size=wing_size, study_pop=study_pop, af1_cutoff=af1_cutoff)

    m_rows, u_rows = pipeline.partition_window(win, start_bp, end_bp)
    M = len(m_rows)
    if M <= settings.min_num_measured_snp:
        raise ValueError(
            f"Not enough number of SNPs loaded - QCAT not performed "
            f"(measured={M})")

    Gm = pipeline.genotypes_for(win, m_rows)
    Gu = pipeline.genotypes_for(win, u_rows)
    B11 = ldkernels.pooled_corr(Gm, Gm)
    B11 = ldkernels.set_diag(B11, 1.0 + settings.lambda_)
    B21 = (ldkernels.pooled_corr(Gu, Gm)
           if len(u_rows) else np.zeros((0, M)))
    Z1 = win.table["z"].to_numpy()[m_rows]

    bp_m = win.table["bp"].to_numpy()[m_rows]
    pred_measured_pos = np.flatnonzero((bp_m >= start_bp) & (bp_m <= end_bp))
    num_eig, res = _qcat_core(B11, B21, Z1, pred_measured_pos, settings)
    return _qcat_assemble(win, start_bp, end_bp, "af1ref", m_rows, u_rows,
                          num_eig, res)


def qcatmix(
    chrom: int,
    start_bp: int,
    end_bp: int,
    wing_size: int,
    pop_wgt_df: pd.DataFrame,
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> pd.DataFrame:
    """Cosmopolitan causality test (reference: src/qcatmix.cpp).
    NOTE: unlike qcat (0.05), qcatmix's default af1_cutoff is 0.01
    (src/qcatmix.cpp:61-64; caught by the compiled-reference diff)."""
    if af1_cutoff is None:
        af1_cutoff = 0.01
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    inp = readers.read_input_z(input_file, chrom=chrom, start_bp=start_bp,
                               end_bp=end_bp, wing_size=wing_size)
    win = pipeline.load_window(
        panel, inp, chrom=chrom, start_bp=start_bp, end_bp=end_bp,
        wing_size=wing_size, pop_wgt=readers.pop_wgt_map_from_df(pop_wgt_df),
        af1_cutoff=af1_cutoff)

    m_rows, u_rows = pipeline.partition_window(win, start_bp, end_bp)
    M, U = len(m_rows), len(u_rows)
    if M <= settings.min_num_measured_snp or U <= settings.min_num_unmeasured_snp:
        raise ValueError(
            f"Not enough number of SNPs loaded - QCATMIX not performed "
            f"(measured={M}, unmeasured={U})")

    Gm = pipeline.genotypes_for(win, m_rows)
    Gu = pipeline.genotypes_for(win, u_rows)
    std_m = ldkernels.weighted_std(Gm, win.pop_sizes, win.pop_wgts)
    std_u = ldkernels.weighted_std(Gu, win.pop_sizes, win.pop_wgts)
    B11 = ldkernels.weighted_corr(Gm, Gm, win.pop_sizes, win.pop_wgts,
                                  std_a=std_m, std_b=std_m)
    B11 = ldkernels.set_diag(B11, 1.0 + settings.lambda_)
    B21 = ldkernels.weighted_corr(Gu, Gm, win.pop_sizes, win.pop_wgts,
                                  std_a=std_u, std_b=std_m)
    Z1 = win.table["z"].to_numpy()[m_rows]

    bp_m = win.table["bp"].to_numpy()[m_rows]
    pred_measured_pos = np.flatnonzero((bp_m >= start_bp) & (bp_m <= end_bp))
    num_eig, res = _qcat_core(B11, B21, Z1, pred_measured_pos, settings)
    return _qcat_assemble(win, start_bp, end_bp, "af1mix", m_rows, u_rows,
                          num_eig, res)


def prep_qcat(
    chrom: int,
    start_bp: int,
    end_bp: int,
    wing_size: int,
    study_pop: str,
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> Dict[str, object]:
    """Raw QCAT ingredients (reference: src/prep_qcat.cpp):
    snplist of ALL kept SNPs, Z1, B11 (unit diagonal, no ridge), and B21
    for all non-type-2 SNPs in the prediction window."""
    if af1_cutoff is None:
        af1_cutoff = 0.01
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    inp = readers.read_input_z(input_file, chrom=chrom, start_bp=start_bp,
                               end_bp=end_bp, wing_size=wing_size)
    win = pipeline.load_window(
        panel, inp, chrom=chrom, start_bp=start_bp, end_bp=end_bp,
        wing_size=wing_size, study_pop=study_pop, af1_cutoff=af1_cutoff)

    t = win.table
    typ = t["type"].to_numpy()
    bp = t["bp"].to_numpy()
    m_rows = np.flatnonzero(typ == 1)
    # all non-type-2 SNPs inside the prediction window (includes measured!)
    p_rows = np.flatnonzero((typ != 2) & (bp >= start_bp) & (bp <= end_bp))
    M = len(m_rows)
    if M <= settings.min_num_measured_snp:
        raise ValueError(
            f"Not enough number of SNPs loaded - QCAT not performed "
            f"(measured={M})")

    Gm = pipeline.genotypes_for(win, m_rows)
    Gp = pipeline.genotypes_for(win, p_rows)
    B11 = ldkernels.pooled_corr(Gm, Gm)
    B11 = ldkernels.set_diag(B11, 1.0)
    B21 = ldkernels.pooled_corr(Gp, Gm)
    Z1 = t["z"].to_numpy()[m_rows]

    snplist = pd.DataFrame({
        "rsid": t["rsid"].to_numpy(),
        "chr": t["chr"].to_numpy(),
        "bp": t["bp"].to_numpy(),
        "a1": t["a1"].to_numpy(),
        "a2": t["a2"].to_numpy(),
        "af1ref": t["af1ref"].to_numpy(),
        "z": t["z"].to_numpy(),
        "type": t["type"].to_numpy(),
    })
    return {"snplist": snplist, "z_vec": Z1, "cor_mat1": B11, "cor_mat2": B21}


def prep_recessive_impute(
    chrom: int,
    start_bp: int,
    end_bp: int,
    wing_size: int,
    pop_wgt_df: pd.DataFrame,
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> Dict[str, object]:
    """Imputation prep under additive/dominant/recessive codings
    (reference: src/prep_qcatmix.cpp:36-303).  Genotypes are first
    minor-allele-normalized (af1mix > 0.5 rows flipped)."""
    if af1_cutoff is None:
        af1_cutoff = 0.01
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    inp = readers.read_input_z(input_file, chrom=chrom, start_bp=start_bp,
                               end_bp=end_bp, wing_size=wing_size)
    win = pipeline.load_window(
        panel, inp, chrom=chrom, start_bp=start_bp, end_bp=end_bp,
        wing_size=wing_size, pop_wgt=readers.pop_wgt_map_from_df(pop_wgt_df),
        af1_cutoff=af1_cutoff)

    t = win.table
    typ = t["type"].to_numpy()
    bp = t["bp"].to_numpy()
    has_geno = win.g_row >= 0

    # minor-allele normalization over ALL kept panel SNPs (reference
    # applies it to the whole snp_vec, src/prep_qcatmix.cpp:101)
    af = t["af1mix"].to_numpy().copy()
    z = t["z"].to_numpy().copy()
    a1 = t["a1"].to_numpy(dtype=object).copy()
    a2 = t["a2"].to_numpy(dtype=object).copy()
    rows = np.flatnonzero(has_geno)
    Gall = win.G[win.g_row[rows]]
    G2, af2, z2, a1_2, a2_2, _ = dosage.minor_allele_update(
        Gall, af[rows], z[rows], a1[rows], a2[rows])
    af[rows], z[rows], a1[rows], a2[rows] = af2, z2, a1_2, a2_2
    t = t.assign(af1mix=af, z=z, a1=a1, a2=a2)

    g_of = {r: i for i, r in enumerate(rows)}
    m_rows = np.flatnonzero(typ == 1)
    p_rows = np.flatnonzero((typ != 2) & (bp >= start_bp) & (bp <= end_bp))
    M = len(m_rows)
    if M <= settings.min_num_measured_snp:
        raise ValueError("Not enough number of SNPs loaded - Recessive "
                         f"Imputation not performed (measured={M})")

    Gm = G2[[g_of[r] for r in m_rows]]
    Gp = G2[[g_of[r] for r in p_rows]]
    Gp_dom = dosage.to_dominant(Gp)
    Gp_rec = dosage.to_recessive(Gp)

    sizes, wgts = win.pop_sizes, win.pop_wgts
    std_m = ldkernels.weighted_std(Gm, sizes, wgts)
    std_p = ldkernels.weighted_std(Gp, sizes, wgts)
    std_p_dom = ldkernels.weighted_std(Gp_dom, sizes, wgts)
    std_p_rec = ldkernels.weighted_std(Gp_rec, sizes, wgts)

    cormat = ldkernels.weighted_corr(Gm, Gm, sizes, wgts, std_m, std_m)
    cormat = ldkernels.set_diag(cormat, 1.0)
    cormat_add = ldkernels.weighted_corr(Gp, Gm, sizes, wgts, std_p, std_m)
    cormat_dom = ldkernels.weighted_corr(Gp_dom, Gm, sizes, wgts,
                                         std_p_dom, std_m)
    cormat_rec = ldkernels.weighted_corr(Gp_rec, Gm, sizes, wgts,
                                         std_p_rec, std_m)

    tp = t.iloc[p_rows]
    snplist = pd.DataFrame({
        "rsid": tp["rsid"].to_numpy(),
        "chr": tp["chr"].to_numpy(),
        "bp": tp["bp"].to_numpy(),
        "a1": tp["a1"].to_numpy(),
        "a2": tp["a2"].to_numpy(),
        "af1mix": tp["af1mix"].to_numpy(),
        "z": tp["z"].to_numpy(),
        "type": tp["type"].to_numpy(),
    })
    return {
        "snplist": snplist,
        "zvec": t["z"].to_numpy()[m_rows],
        "cormat": cormat,
        "cormat_add": cormat_add,
        "cormat_dom": cormat_dom,
        "cormat_rec": cormat_rec,
    }
