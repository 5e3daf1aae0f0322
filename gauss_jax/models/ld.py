"""computeLD / simulateLD: ancestry-weighted LD matrices.

JAX rebuild of the reference kernels:
* computeLD (reference: src/computeLD.cpp:26-166)
* simulateLD (reference: src/simulateLD.cpp:32-254)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pandas as pd

from ..config import PanelFiles, Settings, DEFAULT_SETTINGS
from ..core import ldkernels
from ..io import readers
from . import pipeline


def compute_ld(
    chrom: int,
    start_bp: int,
    end_bp: int,
    pop_wgt_df: pd.DataFrame,
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> Dict[str, object]:
    """Ancestry-weighted LD (correlation) matrix for measured SNPs.

    Mirrors the reference computeLD (src/computeLD.cpp): wing_size=0,
    weighted correlations among type-1 SNPs with unit diagonal.  Returns
    {"snplist": DataFrame, "cormat": float64 [M, M]}.
    """
    if af1_cutoff is None:
        af1_cutoff = 0.01
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    inp = readers.read_input_z(input_file, chrom=chrom, start_bp=start_bp,
                               end_bp=end_bp, wing_size=0)
    win = pipeline.load_window(
        panel, inp, chrom=chrom, start_bp=start_bp, end_bp=end_bp,
        wing_size=0, pop_wgt=readers.pop_wgt_map_from_df(pop_wgt_df),
        af1_cutoff=af1_cutoff)

    measured = np.flatnonzero(win.table["type"].to_numpy() == 1)
    num_measured = len(measured)
    if num_measured <= settings.min_num_measured_snp:
        raise ValueError(
            f"Not enough number of SNPs loaded - computeLD not performed "
            f"(measured={num_measured})")

    G = pipeline.genotypes_for(win, measured)
    std = ldkernels.weighted_std(G, win.pop_sizes, win.pop_wgts)
    cor = ldkernels.weighted_corr(G, G, win.pop_sizes, win.pop_wgts,
                                  std_a=std, std_b=std)
    cor = ldkernels.set_diag(cor, 1.0)

    t = win.table.iloc[measured]
    snplist = pd.DataFrame({
        "rsid": t["rsid"].to_numpy(),
        "chr": t["chr"].to_numpy(),
        "bp": t["bp"].to_numpy(),
        "a1": t["a1"].to_numpy(),
        "a2": t["a2"].to_numpy(),
        "af1mix": t["af1mix"].to_numpy(),
    })
    return {"snplist": snplist, "cormat": cor}


def simulate_ld(
    chrom: int,
    start_bp: int,
    end_bp: int,
    pop_wgt_df: pd.DataFrame,
    sim_size: int,
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
    seed: Optional[int] = None,
) -> Dict[str, object]:
    """LD matrix of a simulated cohort (reference: src/simulateLD.cpp).

    Per selected population k, draws floor(wgt_k * sim_size) subjects
    with replacement from the panel, then computes the plain Pearson
    correlation matrix over the simulated subjects.  The reference seeds
    std::mt19937 from std::random_device; pass ``seed`` for
    reproducibility.
    """
    if af1_cutoff is None:
        af1_cutoff = 0.01
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    inp = readers.read_input_z(input_file, chrom=chrom, start_bp=start_bp,
                               end_bp=end_bp, wing_size=0)
    pop_wgt = readers.pop_wgt_map_from_df(pop_wgt_df)
    win = pipeline.load_window(
        panel, inp, chrom=chrom, start_bp=start_bp, end_bp=end_bp,
        wing_size=0, pop_wgt=pop_wgt, af1_cutoff=af1_cutoff)

    measured = np.flatnonzero(win.table["type"].to_numpy() == 1)
    num_measured = len(measured)
    if num_measured <= settings.min_num_measured_snp:
        raise ValueError(
            f"Not enough number of SNPs loaded - computeLD not performed "
            f"(measured={num_measured})")
    G = pipeline.genotypes_for(win, measured)

    rng = np.random.default_rng(seed)
    bounds = np.concatenate([[0], np.cumsum(win.pop_sizes)])
    cols = []
    desc = win.desc
    for j, k in enumerate(win.pop_index):
        pop = desc.pops[k]
        n_sim = int(pop_wgt[pop] * sim_size)  # truncation, like (int) cast
        if n_sim <= 0:
            continue
        draw = rng.integers(0, int(win.pop_sizes[j]), size=n_sim)
        cols.append(G[:, bounds[j]:bounds[j + 1]][:, draw])
    sim = np.concatenate(cols, axis=1).astype(np.float64)

    # Pearson correlation across simulated subjects (reference:
    # src/simulateLD.cpp:257-271).
    n = sim.shape[1]
    s = sim.sum(axis=1)
    q = (sim * sim).sum(axis=1)
    cp = sim @ sim.T
    numer = n * cp - np.outer(s, s)
    den = np.sqrt(n * q - s * s)
    cor = numer / np.outer(den, den)
    np.fill_diagonal(cor, 1.0)

    t = win.table.iloc[measured]
    snplist = pd.DataFrame({
        "rsid": t["rsid"].to_numpy(),
        "chr": t["chr"].to_numpy(),
        "bp": t["bp"].to_numpy(),
        "a1": t["a1"].to_numpy(),
        "a2": t["a2"].to_numpy(),
        "af1mix": t["af1mix"].to_numpy(),
    })
    return {"snplist": snplist, "cormat": cor}
