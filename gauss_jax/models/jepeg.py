"""JEPEG / JEPEGMIX: gene-level joint TWAS tests of functional SNPs.

JAX rebuild of:
* jepeg    (reference: src/jepeg.cpp:28-153, src/gene.cpp:288-550)
* jepegmix (reference: src/jepegmix.cpp:26-161, src/gene.cpp:553-822)

Gene correlation matrices run as bucketed batched matmuls
(core/genekernels.py); the category statistics, pruning and chi-square
per gene are tiny float64 host math reproducing the reference's exact
pruning order.

Note: this code version of the reference does NOT impute unmeasured
functional SNPs first (imputation_flag commented out, src/gauss.h:23-24);
W uses info = 1.0 for measured SNPs (src/gene.cpp:871 via
Snp::GetInfo set by ReadInputZ).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from ..config import PanelFiles, Settings, DEFAULT_SETTINGS
from ..core import genekernels, linalg, variants
from ..io import readers
from ..io.panel import PanelReader, read_panel_index
from ..utils.special import pchisq_upper, pnorm_two_sided
from . import pipeline


@dataclasses.dataclass
class GeneResult:
    geneid: str = "."
    chisq: float = -1.0
    df: int = 0
    jepeg_pval: float = -1.0
    num_snp: int = 0
    top_categ: str = "."
    top_categ_pval: float = -1.0
    top_snp: str = "."
    top_snp_pval: float = -1.0


def _gene_test(CorG: np.ndarray, z: np.ndarray, info: np.ndarray,
               rsid: np.ndarray, geneid: str,
               categ_wgt: np.ndarray,  # [n, 6] weights (0 where absent)
               categ_present: np.ndarray,  # [n, 6] bool membership
               settings: Settings) -> GeneResult:
    """Per-gene JEPEG statistic (reference: CalJepegPval,
    src/gene.cpp:288-550).  CorG must already carry the 1+lambda ridge
    diagonal."""
    counts = categ_present.sum(axis=0)          # per category SNP counts
    present = np.flatnonzero(counts > 0)        # category numbers, ascending
    if len(present) == 0:
        return GeneResult(num_snp=len(z))

    # W[k, n] = annot weight * sqrt(info) (reference: GetW,
    # src/gene.cpp:859-877; GetCategWgt returns 0 for absent categories)
    W = (categ_wgt[:, present] * np.sqrt(info)[:, None]).T
    WWt = W @ W.T
    CovU = W @ CorG @ W.T
    U = W @ z
    return _gene_test_core(CovU, WWt, U, z, rsid, geneid, present, settings)


def _gene_test_stats(CovU6: np.ndarray, WWt6: np.ndarray, U6: np.ndarray,
                     z: np.ndarray, rsid: np.ndarray, geneid: str,
                     categ_present: np.ndarray,
                     settings: Settings) -> GeneResult:
    """Per-gene test from device-precomputed 6-category statistics
    (core/genekernels.gene_stats_resident): absent categories are
    all-zero rows/cols, so restricting to the present set reproduces
    _gene_test's W exactly."""
    counts = categ_present.sum(axis=0)
    present = np.flatnonzero(counts > 0)
    if len(present) == 0:
        return GeneResult(num_snp=len(z))
    sel = np.ix_(present, present)
    return _gene_test_core(CovU6[sel], WWt6[sel], U6[present], z, rsid,
                           geneid, present, settings)


def _gene_test_core(CovU: np.ndarray, WWt: np.ndarray, U: np.ndarray,
                    z: np.ndarray, rsid: np.ndarray, geneid: str,
                    present: np.ndarray,
                    settings: Settings) -> GeneResult:
    """Category pruning + chi-square given the k<=6 category statistics
    (reference: CalJepegPval src/gene.cpp:288-550 after CovU is built)."""
    res = GeneResult(num_snp=len(z))
    k = len(present)
    with np.errstate(invalid="ignore", divide="ignore"):
        CorU = linalg.cov_to_cor(CovU)
    varU = np.diag(CovU)
    with np.errstate(invalid="ignore", divide="ignore"):
        categ_pval = pnorm_two_sided(U / np.sqrt(varU))

    rmv = np.zeros(k, dtype=bool)
    # collinear pruning, high index downwards; inner loop scans ALL lower
    # indices including already-removed ones (reference:
    # src/gene.cpp:391-399)
    for j in range(k - 1, 0, -1):
        for i in range(j):
            if abs(CorU[i, j]) > settings.categ_cor_cutoff:
                rmv[j] = True
                break
    # low-variance pruning (reference: src/gene.cpp:408-414)
    rmv |= varU < np.diag(WWt) / settings.denorm_norm_w

    df = int(k - rmv.sum())
    res.df = df
    if df == 0:
        return res

    keep = ~rmv
    X = U[keep]
    CovX = CovU[np.ix_(keep, keep)]
    CovX = linalg.make_pos_def(CovX, settings.min_abs_eig)
    chisq = float(X @ linalg.inv_mat(CovX) @ X)
    res.chisq = chisq
    res.jepeg_pval = float(pchisq_upper(chisq, df))
    res.geneid = geneid

    # top category: literal reference loop (GetTopCateg,
    # src/gene.cpp:880-891) -- starts at index 0 even if removed
    top = 0
    for i in range(k):
        if categ_pval[top] > categ_pval[i] and not rmv[i]:
            top = i
    res.top_categ = readers.CATEG_NAME[present[top]]
    res.top_categ_pval = float(categ_pval[top])

    # top SNP: strictly larger |z| wins (GetTopSNP, src/gene.cpp:894-904)
    tsnp = int(np.argmax(np.abs(z)))
    res.top_snp = str(rsid[tsnp])
    res.top_snp_pval = float(pnorm_two_sided(z[tsnp]))
    return res


def run_gene_tests(zs: np.ndarray, infos: np.ndarray, rsids: np.ndarray,
                   gids: np.ndarray, spans, corrs,
                   cw_rows: np.ndarray, cp_rows: np.ndarray,
                   settings: Settings) -> pd.DataFrame:
    """Host-side per-gene statistics for pre-gathered gene blocks.

    zs/infos/rsids/gids/cw_rows/cp_rows are aligned to the sorted gene
    SNP order; ``spans`` is a list of (start, end) slices (one per gene,
    matching ``corrs``, the per-gene correlation matrices WITHOUT the
    ridge diagonal).  Reference per-gene loop: src/jepeg.cpp:114-131.
    """
    results: List[GeneResult] = []
    for gi, (s, e) in enumerate(spans):
        CorG = corrs[gi].copy()
        np.fill_diagonal(CorG, 1.0 + settings.lambda_)
        results.append(_gene_test(
            CorG, zs[s:e], infos[s:e], rsids[s:e], gids[s],
            cw_rows[s:e], cp_rows[s:e], settings))
    return _results_frame(results)


def run_gene_tests_stats(zs: np.ndarray, rsids: np.ndarray,
                         gids: np.ndarray, spans, stats6,
                         cp_rows: np.ndarray,
                         settings: Settings) -> pd.DataFrame:
    """Gene tests from device-precomputed category statistics
    (``stats6``: one (CovU [6,6], WWt [6,6], U [6]) tuple per gene from
    core/genekernels.gene_stats_resident).  Only the k<=6 pruning and
    chi-square remain on the host."""
    results: List[GeneResult] = []
    for gi, (s, e) in enumerate(spans):
        CovU6, WWt6, U6 = stats6[gi]
        results.append(_gene_test_stats(
            CovU6, WWt6, U6, zs[s:e], rsids[s:e], gids[s],
            cp_rows[s:e], settings))
    return _results_frame(results)


def _results_frame(results: List[GeneResult]) -> pd.DataFrame:
    return pd.DataFrame({
        "geneid": [r.geneid for r in results],
        "chisq": [r.chisq for r in results],
        "df": [r.df for r in results],
        "jepeg_pval": [r.jepeg_pval for r in results],
        "num_snp": [r.num_snp for r in results],
        "top_categ": [r.top_categ for r in results],
        "top_categ_pval": [r.top_categ_pval for r in results],
        "top_snp": [r.top_snp for r in results],
        "top_snp_pval": [r.top_snp_pval for r in results],
    })


def empty_gene_frame() -> pd.DataFrame:
    """Typed empty result frame (so concatenation with non-empty chunk
    shards keeps numeric dtypes)."""
    return pd.DataFrame({
        "geneid": pd.Series(dtype=object),
        "chisq": pd.Series(dtype=np.float64),
        "df": pd.Series(dtype=np.int64),
        "jepeg_pval": pd.Series(dtype=np.float64),
        "num_snp": pd.Series(dtype=np.int64),
        "top_categ": pd.Series(dtype=object),
        "top_categ_pval": pd.Series(dtype=np.float64),
        "top_snp": pd.Series(dtype=object),
        "top_snp_pval": pd.Series(dtype=np.float64),
    })


def _jepeg_common(
    input_file: str,
    annotation_file: str,
    panel: PanelFiles,
    af1_cutoff: float,
    study_pop: Optional[str],
    pop_wgt: Optional[Dict[str, float]],
    settings: Settings,
) -> pd.DataFrame:
    inp = readers.read_input_z(input_file, all_snps=True)
    desc = readers.read_pop_desc(panel.pop_desc_file)
    if study_pop is not None:
        flags = readers.init_pop_flags(desc, study_pop)
        wgts = None
    else:
        flags, wgts = readers.init_pop_flag_wgts(desc, pop_wgt)

    idx = read_panel_index(panel.index_file)
    table = variants.join_reference_index(inp, idx, add_unmeasured=False,
                                          flip_af1study=True)
    annot = readers.read_annotation(annotation_file)
    table, categs = variants.join_annotation(table, annot)

    # MakeSnpVec[Mix]: AF filter on panel rows (type-2 rows kept, but the
    # gene filter below requires type 1 anyway)
    reader = PanelReader(panel.data_file, desc)
    has_row = table["fpos"].to_numpy() >= 0
    fpos = table["fpos"].to_numpy()[has_row]
    dec = reader.decode_rows(fpos, pop_flags=flags, want_genotypes=True,
                             want_af=True)
    n = len(table)
    g_row = np.full(n, -1, dtype=np.int64)
    g_row[has_row] = np.arange(int(has_row.sum()))

    # type-2 rows drop like the reference's MakeSnpVec[Mix] NaN-filter
    # (models/pipeline.load_window docstring)
    keep = np.asarray(has_row).copy()
    sel = dec.pop_index
    if study_pop is not None:
        counts = dec.G.astype(np.int64).sum(axis=1)
        af_rows = counts / (2.0 * float(dec.pop_sizes.sum()))
        af_rows = np.ceil(af_rows * 100000.0) / 100000.0
        af = np.full(n, np.nan)
        af[has_row] = af_rows
        table = table.assign(af1ref=af)
    else:
        af = np.full(n, np.nan)
        af[has_row] = dec.af[:, sel] @ wgts
        table = table.assign(af1mix=af)
    keep[has_row] = (af[has_row] > af1_cutoff) & (af[has_row] < 1 - af1_cutoff)

    # gene SNPs: measured + annotated (reference: src/jepeg.cpp:73-79)
    typ = table["type"].to_numpy()
    gid = table["geneid"].to_numpy()
    gene_mask = keep & (typ == 1) & (gid != ".")
    gene_rows = np.flatnonzero(gene_mask)

    # category weight matrices [n_rows, 6]
    cw = np.zeros((n, 6))
    cp = np.zeros((n, 6), dtype=bool)
    if len(categs):
        r = categs["row"].to_numpy(dtype=np.int64)
        c = categs["categ"].to_numpy(dtype=np.int64)
        cw[r, c] = categs["wgt"].to_numpy()
        cp[r, c] = True

    # sort gene SNPs by geneid (stable; reference std::sort by geneid,
    # src/jepeg.cpp:87)
    sub = table.iloc[gene_rows]
    order = np.argsort(sub["geneid"].to_numpy(), kind="stable")
    gene_rows = gene_rows[order]
    sub = table.iloc[gene_rows]

    # group contiguous gene runs
    gids = sub["geneid"].to_numpy()
    starts = np.flatnonzero(np.concatenate([[True], gids[1:] != gids[:-1]]))
    ends = np.concatenate([starts[1:], [len(gids)]])

    gene_G = [dec.G[g_row[gene_rows[s:e]]] for s, e in zip(starts, ends)]
    if not gene_G:
        return empty_gene_frame()

    corrs = genekernels.gene_corr_matrices(
        gene_G, tuple(int(x) for x in dec.pop_sizes),
        tuple(float(x) for x in wgts) if wgts is not None else None)

    return run_gene_tests(
        sub["z"].to_numpy(), sub["info"].to_numpy(),
        sub["rsid"].to_numpy(), gids, list(zip(starts, ends)), corrs,
        cw[gene_rows], cp[gene_rows], settings)


def jepeg(
    study_pop: str,
    input_file: str,
    annotation_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> pd.DataFrame:
    """Homogeneous-cohort gene-level TWAS (reference: src/jepeg.cpp)."""
    if af1_cutoff is None:
        af1_cutoff = 0.01
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    return _jepeg_common(input_file, annotation_file, panel, af1_cutoff,
                         study_pop, None, settings)


def jepegmix(
    pop_wgt_df: pd.DataFrame,
    input_file: str,
    annotation_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> pd.DataFrame:
    """Cosmopolitan gene-level TWAS (reference: src/jepegmix.cpp)."""
    if af1_cutoff is None:
        af1_cutoff = 0.01
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    return _jepeg_common(input_file, annotation_file, panel, af1_cutoff,
                         None, readers.pop_wgt_map_from_df(pop_wgt_df),
                         settings)
