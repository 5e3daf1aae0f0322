"""dist / distmix: conditional-Gaussian imputation of association
Z-scores for unmeasured SNPs.

JAX rebuild of the reference kernels:
* dist     (reference: src/dist.cpp:30-227) -- homogeneous cohorts
* distmix  (reference: src/distmix.cpp:30-253) -- cosmopolitan cohorts

The per-SNP imputation loop (b21 * B11^-1 * Z1 one SNP at a time,
reference src/distmix.cpp:209-236) becomes two dense matmuls:
    A   = B21 @ B11^{-1}            [U, M]
    z2  = A @ Z1                    [U]
    info= |rowsum(A * B21)|         [U]
    z   = z2 / sqrt(info)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pandas as pd

from ..config import PanelFiles, Settings, DEFAULT_SETTINGS
from ..core import ldkernels, linalg
from ..io import readers
from ..utils.special import pnorm_two_sided
from . import pipeline


def _impute(B11: np.ndarray, B21: np.ndarray, Z1: np.ndarray,
            settings: Settings):
    """Shared imputation math.  B11 must already carry the ridge diagonal
    1+lambda (reference: src/dist.cpp:172)."""
    B11 = linalg.make_pos_def(B11, settings.min_abs_eig)
    B11inv = linalg.inv_mat(B11)
    A = B21 @ B11inv
    z2 = A @ Z1
    info = np.abs(np.einsum("um,um->u", A, B21))
    z = z2 / np.sqrt(info)
    return z, info


def _assemble_output(win, start_bp, end_bp, af_col: str) -> pd.DataFrame:
    t = win.table
    mask = (t["bp"].to_numpy() >= start_bp) & (t["bp"].to_numpy() <= end_bp)
    t = t[mask]
    return pd.DataFrame({
        "rsid": t["rsid"].to_numpy(),
        "chr": t["chr"].to_numpy(),
        "bp": t["bp"].to_numpy(),
        "a1": t["a1"].to_numpy(),
        "a2": t["a2"].to_numpy(),
        af_col: t[af_col].to_numpy(),
        "z": t["z"].to_numpy(),
        "pval": pnorm_two_sided(t["z"].to_numpy()),
        "info": t["info"].to_numpy(),
        "type": t["type"].to_numpy(),
    })


def dist(
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
    """Homogeneous-cohort imputation (reference: src/dist.cpp)."""
    if af1_cutoff is None:
        af1_cutoff = 0.01
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    inp = readers.read_input_z(input_file, chrom=chrom, start_bp=start_bp,
                               end_bp=end_bp, wing_size=wing_size)
    win = pipeline.load_window(
        panel, inp, chrom=chrom, start_bp=start_bp, end_bp=end_bp,
        wing_size=wing_size, study_pop=study_pop, af1_cutoff=af1_cutoff)

    measured, unmeasured = pipeline.partition_window(win, start_bp, end_bp)
    M, U = len(measured), len(unmeasured)
    if M <= settings.min_num_measured_snp or U <= settings.min_num_unmeasured_snp:
        raise ValueError(
            f"Not enough number of SNPs loaded - DIST not performed "
            f"(measured={M}, unmeasured={U})")

    Gm = pipeline.genotypes_for(win, measured)
    Gu = pipeline.genotypes_for(win, unmeasured)
    B11 = ldkernels.pooled_corr(Gm, Gm)
    B11 = ldkernels.set_diag(B11, 1.0 + settings.lambda_)
    B21 = ldkernels.pooled_corr(Gu, Gm)
    Z1 = win.table["z"].to_numpy()[measured]

    z, info = _impute(B11, B21, Z1, settings)
    win.table.loc[win.table.index[unmeasured], "z"] = z
    win.table.loc[win.table.index[unmeasured], "info"] = info
    return _assemble_output(win, start_bp, end_bp, "af1ref")


def distmix(
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
    """Cosmopolitan imputation (reference: src/distmix.cpp).  The
    flagship workload (BASELINE.json north star)."""
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

    measured, unmeasured = pipeline.partition_window(win, start_bp, end_bp)
    M, U = len(measured), len(unmeasured)
    if M <= settings.min_num_measured_snp or U <= settings.min_num_unmeasured_snp:
        raise ValueError(
            f"Not enough number of SNPs loaded - DISTMIX not performed "
            f"(measured={M}, unmeasured={U})")

    Gm = pipeline.genotypes_for(win, measured)
    Gu = pipeline.genotypes_for(win, unmeasured)
    std_m = ldkernels.weighted_std(Gm, win.pop_sizes, win.pop_wgts)
    std_u = ldkernels.weighted_std(Gu, win.pop_sizes, win.pop_wgts)
    B11 = ldkernels.weighted_corr(Gm, Gm, win.pop_sizes, win.pop_wgts,
                                  std_a=std_m, std_b=std_m)
    B11 = ldkernels.set_diag(B11, 1.0 + settings.lambda_)
    B21 = ldkernels.weighted_corr(Gu, Gm, win.pop_sizes, win.pop_wgts,
                                  std_a=std_u, std_b=std_m)
    Z1 = win.table["z"].to_numpy()[measured]

    z, info = _impute(B11, B21, Z1, settings)
    win.table.loc[win.table.index[unmeasured], "z"] = z
    win.table.loc[win.table.index[unmeasured], "info"] = info
    return _assemble_output(win, start_bp, end_bp, "af1mix")
