"""Ancestry-proportion estimation: afmix, cpw2, prep_zmix family, zmix.

JAX rebuild of:
* afmix    (reference: src/afmix.cpp:30-215) -- AF regression
* cpw2     (reference: src/cpw2.cpp:31-211) -- arcsine-sqrt variant
* prep_zmix .. prep_zmix5_sup (reference: src/zmix.cpp) -- z*z ~ LD
  regression datasets
* zmix     (reference: R/zmix.R:15-117) -- simplex-constrained QP fit
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

from ..config import PanelFiles, Settings, DEFAULT_SETTINGS
from ..core import ldkernels, linalg, variants
from ..io import readers
from ..io.panel import PanelReader, read_panel_index
from ..utils.qp import solve_simplex_qp
from ..utils.special import quantile_type7


# ---------------------------------------------------------------------------
# Shared loading
# ---------------------------------------------------------------------------

def _load_measured(input_df: pd.DataFrame, panel: PanelFiles
                   ) -> Tuple[pd.DataFrame, readers.PopDesc]:
    """ReadInput* + ReadReferenceIndexAll-style join; returns measured
    (type 1) rows in MapKey order."""
    desc = readers.read_pop_desc(panel.pop_desc_file)
    idx = read_panel_index(panel.index_file)
    table = variants.join_reference_index(
        input_df, idx, add_unmeasured=False, flip_af1study=True)
    measured = table[table["type"] == 1].reset_index(drop=True)
    return measured, desc


def _panel_afs(measured: pd.DataFrame, panel: PanelFiles,
               desc: readers.PopDesc) -> np.ndarray:
    reader = PanelReader(panel.data_file, desc)
    dec = reader.decode_rows(measured["fpos"].to_numpy(),
                             want_genotypes=False, want_af=True)
    return dec.af  # [n, P] all pops


def _panel_genotypes(measured: pd.DataFrame, panel: PanelFiles,
                     desc: readers.PopDesc) -> np.ndarray:
    reader = PanelReader(panel.data_file, desc)
    dec = reader.decode_rows(measured["fpos"].to_numpy(),
                             want_genotypes=True, want_af=False)
    return dec.G  # [n, S] all pops


# ---------------------------------------------------------------------------
# afmix / cpw2
# ---------------------------------------------------------------------------

def _afmix_weights(af_study: np.ndarray, af_panel: np.ndarray,
                   interval: int, transform: bool,
                   min_abs_eig: float) -> np.ndarray:
    """Strided-subset OLS (reference: afmix_vec, src/afmix.cpp:114-215).

    For each of ``interval`` strided subsets, regress study AF on panel
    per-population AFs via covariance blocks (Cxx^-1 Cxy with MakePosDef)
    and average the coefficient vectors.  Negative averages are zeroed;
    positives are rounded half-up to 3 decimals
    (src/afmix.cpp:195-202).
    """
    n, P = af_panel.shape
    mat_full = np.column_stack([af_study, af_panel]).astype(np.float64)
    if transform:
        mat_full = np.arcsin(np.sqrt(mat_full))
    W = np.zeros(P)
    with np.errstate(invalid="ignore", divide="ignore"):
        for i in range(interval):
            mat = mat_full[i::interval]
            cov = linalg.cal_cov_mat(mat)
            cxy = cov[1:, 0]
            cxx = linalg.make_pos_def(cov[1:, 1:], min_abs_eig)
            wi = linalg.inv_mat(cxx) @ cxy
            W += wi / interval
    return np.where(W < 0, 0.0, np.floor(W * 1000 + 0.5) / 1000)


def afmix(
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    interval: Optional[int] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> pd.DataFrame:
    """Ancestry proportions from allele frequencies (reference:
    src/afmix.cpp).  Returns rows (sup.pop, pop, wgt) with wgt > 0."""
    interval = 1000 if interval is None else int(interval)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    inp = readers.read_input_af(input_file)
    measured, desc = _load_measured(inp, panel)
    af_panel = _panel_afs(measured, panel, desc)
    W = _afmix_weights(measured["af1study"].to_numpy(), af_panel,
                       interval, transform=False,
                       min_abs_eig=settings.min_abs_eig)
    keep = W > 0
    return pd.DataFrame({
        "sup.pop": np.asarray(desc.sup_pops, dtype=object)[keep],
        "pop": np.asarray(desc.pops, dtype=object)[keep],
        "wgt": W[keep],
    })


def cpw2(
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    interval: Optional[int] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> pd.DataFrame:
    """afmix with arcsine-sqrt variance stabilization (reference:
    src/cpw2.cpp:147,166).  Returns rows (pop, wgt) with wgt > 0."""
    interval = 1000 if interval is None else int(interval)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    inp = readers.read_input_af(input_file)
    measured, desc = _load_measured(inp, panel)
    af_panel = _panel_afs(measured, panel, desc)
    W = _afmix_weights(measured["af1study"].to_numpy(), af_panel,
                       interval, transform=True,
                       min_abs_eig=settings.min_abs_eig)
    keep = W > 0
    return pd.DataFrame({
        "pop": np.asarray(desc.pops, dtype=object)[keep],
        "wgt": W[keep],
    })


# ---------------------------------------------------------------------------
# prep_zmix family
# ---------------------------------------------------------------------------

def _pair_rows_all(z: np.ndarray, R: np.ndarray) -> np.ndarray:
    """All pairs i<j in row-major order: [zz | per-group corrs]
    (reference: src/zmix.cpp:157-174)."""
    n = z.size
    iu, ju = np.triu_indices(n, k=1)
    cols = [(z[iu] * z[ju])[:, None]]
    cols.append(R[:, iu, ju].T)  # [pairs, P]
    return np.concatenate(cols, axis=1)


def _per_pop_pair_corr(Ga: np.ndarray, Gb: np.ndarray,
                       bounds: np.ndarray) -> np.ndarray:
    """Per-population Pearson correlation for row-paired SNPs:
    returns [n_pairs, P] (reference per-string CalCor,
    src/util.cpp:153-169)."""
    P = len(bounds) - 1
    out = np.empty((Ga.shape[0], P))
    A = Ga.astype(np.float64)
    B = Gb.astype(np.float64)
    for k in range(P):
        s = slice(int(bounds[k]), int(bounds[k + 1]))
        a, b = A[:, s], B[:, s]
        m = a.shape[1]
        sx, sy = a.sum(1), b.sum(1)
        qx, qy = (a * a).sum(1), (b * b).sum(1)
        sxy = (a * b).sum(1)
        numer = m * sxy - sx * sy
        den = np.sqrt(m * qx - sx * sx) * np.sqrt(m * qy - sy * sy)
        with np.errstate(invalid="ignore", divide="ignore"):
            out[:, k] = numer / den
    return out


def _load_zmix(input_file: str, panel: PanelFiles):
    inp = readers.read_input_z(input_file, all_snps=True)
    return _load_measured(inp, panel)


def _af_norm_var(af_panel: np.ndarray) -> np.ndarray:
    """Normalized AF variance var/(mean*(1-mean)) with population (n)
    denominator (reference: cal_af_norm_var, src/zmix.cpp:1183-1219)."""
    n = af_panel.shape[1]
    mean = af_panel.mean(axis=1)
    var = (af_panel * af_panel).sum(axis=1) / n - mean * mean
    with np.errstate(invalid="ignore", divide="ignore"):
        return var / (mean * (1 - mean))


def prep_zmix(input_file: str, reference_index_file: str,
              reference_data_file: str, reference_pop_desc_file: str,
              interval: Optional[int] = None) -> np.ndarray:
    """All pairs of the strided measured-SNP subset
    (reference: prep_zmix, src/zmix.cpp:941-1075)."""
    interval = 1 if interval is None else int(interval)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    measured, desc = _load_zmix(input_file, panel)
    sub = measured.iloc[::interval]
    G = _panel_genotypes(sub, panel, desc)
    R = ldkernels.per_pop_corr(G, tuple(int(x) for x in desc.sizes))
    return _pair_rows_all(sub["z"].to_numpy(), R)


def prep_zmix2(input_file: str, reference_index_file: str,
               reference_data_file: str, reference_pop_desc_file: str,
               interval: Optional[int] = None,
               offset: Optional[int] = None) -> np.ndarray:
    """Pairs (i, i+offset) stepping by interval over ALL measured SNPs
    (reference: prep_zmix2, src/zmix.cpp:652-786)."""
    interval = 1000 if interval is None else int(interval)
    offset = 3 if offset is None else int(offset)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    measured, desc = _load_zmix(input_file, panel)
    n = len(measured)
    ii = np.arange(0, n, interval)
    ii = ii[ii + offset < n]
    rows_a = measured.iloc[ii]
    rows_b = measured.iloc[ii + offset]
    Ga = _panel_genotypes(rows_a, panel, desc)
    Gb = _panel_genotypes(rows_b, panel, desc)
    bounds = np.concatenate([[0], np.cumsum(desc.sizes)])
    corr = _per_pop_pair_corr(Ga, Gb, bounds)
    zz = rows_a["z"].to_numpy() * rows_b["z"].to_numpy()
    return np.column_stack([zz, corr])


def prep_zmix3(input_file: str, reference_index_file: str,
               reference_data_file: str, reference_pop_desc_file: str,
               interval: Optional[int] = None,
               steps: Optional[int] = None) -> np.ndarray:
    """Each strided-subset SNP paired with its next ``steps`` subset
    neighbours (reference: prep_zmix3, src/zmix.cpp:512-633)."""
    interval = 1000 if interval is None else int(interval)
    steps = 5 if steps is None else int(steps)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    measured, desc = _load_zmix(input_file, panel)
    sub = measured.iloc[::interval].reset_index(drop=True)
    n = len(sub)
    pairs_i, pairs_j = [], []
    for i in range(n):
        for j in range(i + 1, min(i + 1 + steps, n)):
            pairs_i.append(i)
            pairs_j.append(j)
    pairs_i = np.asarray(pairs_i, dtype=np.int64)
    pairs_j = np.asarray(pairs_j, dtype=np.int64)
    G = _panel_genotypes(sub, panel, desc)
    bounds = np.concatenate([[0], np.cumsum(desc.sizes)])
    corr = _per_pop_pair_corr(G[pairs_i], G[pairs_j], bounds)
    z = sub["z"].to_numpy()
    return np.column_stack([z[pairs_i] * z[pairs_j], corr])


def prep_zmix4(input_file: str, reference_index_file: str,
               reference_data_file: str, reference_pop_desc_file: str,
               interval: Optional[int] = None,
               offset: Optional[int] = None) -> np.ndarray:
    """Interleaved offset pairs with a leading h-index column
    (reference: prep_zmix4, src/zmix.cpp:364-493)."""
    interval = 1000 if interval is None else int(interval)
    offset = 3 if offset is None else int(offset)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    measured, desc = _load_zmix(input_file, panel)
    n = len(measured)
    hs, ii = [], []
    for h in range(interval):
        for i in range(h, n, interval):
            if i + offset < n:
                hs.append(h)
                ii.append(i)
    hs = np.asarray(hs, dtype=np.int64)
    ii = np.asarray(ii, dtype=np.int64)
    rows_a = measured.iloc[ii]
    rows_b = measured.iloc[ii + offset]
    Ga = _panel_genotypes(rows_a, panel, desc)
    Gb = _panel_genotypes(rows_b, panel, desc)
    bounds = np.concatenate([[0], np.cumsum(desc.sizes)])
    corr = _per_pop_pair_corr(Ga, Gb, bounds)
    zz = rows_a["z"].to_numpy() * rows_b["z"].to_numpy()
    return np.column_stack([hs.astype(np.float64), zz, corr])


def _per_pop_R_sharded(G: np.ndarray, desc: readers.PopDesc,
                       sup_level: bool, mesh) -> np.ndarray:
    """Per-group correlation matrices R[P|SP, N, N] over a
    (window x subject) device mesh: AIM rows data-parallel over the
    window axis, subjects sharded with one psum
    (parallel.mesh.build_sharded_pair_stats).  The partial statistics
    are exact integers, so the host f64 combine reproduces the
    single-device path bit-for-bit at any shard count.  Super-pop level
    pools the additive per-pop statistics before combining
    (reference: CalCorSup, src/zmix.cpp:1221-1246)."""
    from ..parallel import mesh as meshmod

    n_sub = mesh.shape["subject"]
    n_win = mesh.shape["window"]
    sizes = tuple(int(x) for x in desc.sizes)
    G_layout, _, locs = meshmod.subject_shard_layout(G, sizes, n_sub)
    N = G.shape[0]
    Np = -(-N // n_win) * n_win
    Gp = np.zeros((Np, G_layout.shape[1]), dtype=np.int8)
    Gp[:N] = G_layout
    fn = meshmod.build_sharded_pair_stats(locs, mesh)
    C, S, Q = (np.asarray(a, dtype=np.float64) for a in fn(Gp))
    C, S, Q = C[:, :N, :N], S[:N], Q[:N]

    if sup_level:
        order = desc.sup_pop_order()
        groups = desc.sup_pop_indices()
        ks = [np.asarray(groups[sp]) for sp in order]
        ns = [float(sum(sizes[k] for k in g)) for g in ks]
        C = np.stack([C[g].sum(axis=0) for g in ks])
        S = np.stack([S[:, g].sum(axis=1) for g in ks], axis=1)
        Q = np.stack([Q[:, g].sum(axis=1) for g in ks], axis=1)
    else:
        ns = [float(s) for s in sizes]

    mats = []
    with np.errstate(invalid="ignore", divide="ignore"):
        for k, n in enumerate(ns):
            # CalCor combine (src/util.cpp:153-169), as in
            # stats.pooled_corr_combine
            numer = n * C[k] - np.outer(S[:, k], S[:, k])
            d = np.sqrt(n * Q[:, k] - S[:, k] * S[:, k])
            mats.append(numer / np.outer(d, d))
    return np.stack(mats)


def _zmix5_mat(measured: pd.DataFrame, desc: readers.PopDesc,
               percentile: float, interval: int, sup_level: bool,
               af_fn, geno_fn, mesh=None):
    """prep_zmix5 core given row-subset accessors: ``af_fn(df) -> [n,P]``
    panel AFs and ``geno_fn(df) -> [n,S]`` dosages (bgzf decode for the
    per-call path, array slices for the PanelStore-resident path).
    With ``mesh``, the pair correlations run sharded over the device
    mesh (_per_pop_R_sharded)."""
    sub = measured.iloc[::interval].reset_index(drop=True)
    af_panel = af_fn(sub)
    nv = _af_norm_var(af_panel)
    cutoff = quantile_type7(nv, percentile)
    keep = nv > cutoff
    aims = sub[keep].reset_index(drop=True)
    G = geno_fn(aims)
    z = aims["z"].to_numpy()
    if mesh is not None:
        R = _per_pop_R_sharded(np.ascontiguousarray(G, dtype=np.int8),
                               desc, sup_level, mesh)
        return _pair_rows_all(z, R), desc
    if not sup_level:
        R = ldkernels.per_pop_corr(G, tuple(int(x) for x in desc.sizes))
        return _pair_rows_all(z, R), desc
    # super-population level: pool member-population subject columns
    # before the correlation (reference: CalCorSup, src/zmix.cpp:1221-1246)
    bounds = np.concatenate([[0], np.cumsum(desc.sizes)])
    order = desc.sup_pop_order()
    groups = desc.sup_pop_indices()
    mats = []
    for sp in order:
        cols = np.concatenate(
            [np.arange(bounds[k], bounds[k + 1]) for k in groups[sp]])
        mats.append(ldkernels.pooled_corr(G[:, cols], G[:, cols]))
    R = np.stack(mats)
    return _pair_rows_all(z, R), desc


def _prep_zmix5_core(input_file: str, panel: PanelFiles,
                     percentile: float, interval: int, sup_level: bool):
    measured, desc = _load_zmix(input_file, panel)
    return _zmix5_mat(measured, desc, percentile, interval, sup_level,
                      af_fn=lambda df: _panel_afs(df, panel, desc),
                      geno_fn=lambda df: _panel_genotypes(df, panel, desc))


def prep_zmix5(input_file: str, reference_index_file: str,
               reference_data_file: str, reference_pop_desc_file: str,
               percentile: Optional[float] = None,
               interval: Optional[int] = None) -> np.ndarray:
    """Ancestry-informative-marker selection (top AF-variance quantile)
    then all pairs (reference: prep_zmix5, src/zmix.cpp:44-187)."""
    percentile = 0.99 if percentile is None else float(percentile)
    interval = 1 if interval is None else int(interval)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    mat, _ = _prep_zmix5_core(input_file, panel, percentile, interval, False)
    return mat


def prep_zmix5_sup(input_file: str, reference_index_file: str,
                   reference_data_file: str, reference_pop_desc_file: str,
                   percentile: Optional[float] = None,
                   interval: Optional[int] = None) -> np.ndarray:
    """prep_zmix5 at super-population resolution (reference:
    prep_zmix5_sup, src/zmix.cpp:202-343)."""
    percentile = 0.99 if percentile is None else float(percentile)
    interval = 1 if interval is None else int(interval)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    mat, _ = _prep_zmix5_core(input_file, panel, percentile, interval, True)
    return mat


# ---------------------------------------------------------------------------
# zmix (QP fit)
# ---------------------------------------------------------------------------

def zmix(input_file: str, reference_index_file: str,
         reference_data_file: str, reference_pop_desc_file: str,
         percentile: float = 0.9, interval: int = 10,
         level: str = "population") -> pd.DataFrame:
    """Z-score-based ancestry proportions (reference: R/zmix.R:15-117).

    Regresses z_i*z_j on per-population LD columns under simplex
    constraints; weights are normalized, rounded to 5 decimals, and
    re-normalized exactly as the R wrapper does.
    """
    if level not in ("population", "superpopulation"):
        raise ValueError("level must be 'population' or 'superpopulation'")
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    mat, desc = _prep_zmix5_core(input_file, panel, percentile, interval,
                                 level == "superpopulation")
    return _zmix_fit(mat, desc, level)


def _zmix_fit(mat: np.ndarray, desc: readers.PopDesc,
              level: str) -> pd.DataFrame:
    """Simplex-QP weight fit + normalize/round post-processing
    (reference: R/zmix.R:48-117)."""
    mat = mat[np.isfinite(mat).all(axis=1)]
    if mat.shape[0] == 0:
        raise ValueError("zmix: no valid rows after filtering")
    y, x = mat[:, 0], mat[:, 1:]
    D = x.T @ x
    d = y @ x
    w = solve_simplex_qp(D, d)
    w = w / w.sum()
    w = np.round(w, 5)
    w = w / w.sum()
    if level == "superpopulation":
        return pd.DataFrame({"SuperPopulation": desc.sup_pop_order(),
                             "Weight": w})
    return pd.DataFrame({"Population": desc.pops,
                         "SuperPopulation": desc.sup_pops,
                         "Weight": w})


# ---------------------------------------------------------------------------
# PanelStore-resident variants (decode the panel once, reuse the arrays)
# ---------------------------------------------------------------------------

def _measured_from_store(store, input_df: pd.DataFrame
                         ) -> Tuple[pd.DataFrame, np.ndarray]:
    """Join input against the in-memory panel index
    (ReadReferenceIndexAll semantics: no unmeasured inserts, af1study
    flip on swaps; reference src/gauss.cpp:431-518) and map the measured
    rows to PanelStore row ids."""
    table = variants.join_reference_index(
        input_df, store.index, add_unmeasured=False, flip_af1study=True)
    measured = table[table["type"] == 1].reset_index(drop=True)
    fmap = pd.Series(np.arange(len(store.index)),
                     index=store.index["fpos"].to_numpy())
    rows = fmap.reindex(
        measured["fpos"].to_numpy()).to_numpy().astype(np.int64)
    return measured, rows


def afmix_store(store, input_df: pd.DataFrame,
                interval: Optional[int] = None,
                settings: Settings = DEFAULT_SETTINGS) -> pd.DataFrame:
    """afmix over a resident PanelStore: the per-subset AF matrix comes
    straight from store.af instead of the reference's per-SNP
    bgzf_seek loop (src/afmix.cpp:150-173, re-run per invocation)."""
    interval = 1000 if interval is None else int(interval)
    measured, rows = _measured_from_store(store, input_df)
    W = _afmix_weights(measured["af1study"].to_numpy(), store.af[rows],
                       interval, transform=False,
                       min_abs_eig=settings.min_abs_eig)
    keep = W > 0
    return pd.DataFrame({
        "sup.pop": np.asarray(store.desc.sup_pops, dtype=object)[keep],
        "pop": np.asarray(store.desc.pops, dtype=object)[keep],
        "wgt": W[keep],
    })


def cpw2_store(store, input_df: pd.DataFrame,
               interval: Optional[int] = None,
               settings: Settings = DEFAULT_SETTINGS) -> pd.DataFrame:
    """cpw2 (arcsine-sqrt afmix) over a resident PanelStore."""
    interval = 1000 if interval is None else int(interval)
    measured, rows = _measured_from_store(store, input_df)
    W = _afmix_weights(measured["af1study"].to_numpy(), store.af[rows],
                       interval, transform=True,
                       min_abs_eig=settings.min_abs_eig)
    keep = W > 0
    return pd.DataFrame({
        "pop": np.asarray(store.desc.pops, dtype=object)[keep],
        "wgt": W[keep],
    })


def _zmix5_mat_store(store, input_df: pd.DataFrame, percentile: float,
                     interval: int, sup_level: bool, mesh=None):
    measured, rows = _measured_from_store(store, input_df)
    # carry the store row id as a column: _zmix5_mat resets indices when
    # it subsets, so positional mapping would silently mis-align
    measured = measured.assign(_store_row=rows)
    af_fn = lambda df: store.af[df["_store_row"].to_numpy()]
    geno_fn = lambda df: store.G[df["_store_row"].to_numpy()]
    return _zmix5_mat(measured, store.desc, percentile, interval,
                      sup_level, af_fn=af_fn, geno_fn=geno_fn, mesh=mesh)


def prep_zmix5_store(store, input_df: pd.DataFrame,
                     percentile: Optional[float] = None,
                     interval: Optional[int] = None,
                     sup_level: bool = False, mesh=None) -> np.ndarray:
    """prep_zmix5[_sup] over a resident PanelStore.  ``mesh``: run the
    pair correlations sharded over a (window x subject) device mesh."""
    percentile = 0.99 if percentile is None else float(percentile)
    interval = 1 if interval is None else int(interval)
    mat, _ = _zmix5_mat_store(store, input_df, percentile, interval,
                              sup_level, mesh=mesh)
    return mat


def zmix_store(store, input_df: pd.DataFrame, percentile: float = 0.9,
               interval: int = 10,
               level: str = "population", mesh=None) -> pd.DataFrame:
    """zmix over a resident PanelStore: one panel decode serves AIM
    selection (AF variance), pair correlations, and the QP fit
    (reference re-reads the panel inside prep_zmix5 every call,
    src/zmix.cpp:44-187).  ``mesh``: shard the pair correlations over a
    (window x subject) device mesh."""
    if level not in ("population", "superpopulation"):
        raise ValueError("level must be 'population' or 'superpopulation'")
    mat, desc = _zmix5_mat_store(store, input_df, percentile, interval,
                                 level == "superpopulation", mesh=mesh)
    return _zmix_fit(mat, desc, level)
