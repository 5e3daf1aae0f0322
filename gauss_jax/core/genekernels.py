"""Gene-batched correlation kernels for JEPEG/JEPEGMIX.

Genes are independent small problems (reference loops genes serially,
src/jepeg.cpp:114-131).  Here genes are padded into buckets and their
SNP x SNP correlation matrices are computed as one batched matmul
per bucket: [B, n, S] x [B, S, n] -> [B, n, n], with the same exact-f32
sufficient statistics + f64 combines as the windowed kernels.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import stats


@partial(jax.jit, static_argnames=("pop_sizes",))
def _batched_pooled_corr(Gb, pop_sizes):
    """Gb: [B, n, S] -> pooled correlation [B, n, n] float64."""
    g = Gb.astype(jnp.float32)
    C = jnp.einsum("bns,bms->bnm", g, g,
                   preferred_element_type=jnp.float32)
    S = jnp.sum(g, axis=2)
    Q = jnp.sum(g * g, axis=2)
    n = float(sum(pop_sizes))
    s64 = S.astype(jnp.float64)
    q64 = Q.astype(jnp.float64)
    numer = n * C.astype(jnp.float64) - s64[:, :, None] * s64[:, None, :]
    d = jnp.sqrt(n * q64 - s64 * s64)
    return numer / (d[:, :, None] * d[:, None, :])


@partial(jax.jit, static_argnames=("pop_sizes", "wgts"))
def _batched_weighted_corr(Gb, pop_sizes, wgts):
    """Gb: [B, n, S] -> CalWgtCov-based correlation [B, n, n] float64
    (diagonal = 1 up to rounding; caller overwrites it)."""
    bounds = stats.segment_bounds(pop_sizes)
    m = np.asarray(pop_sizes, dtype=np.float64)
    w = np.asarray(wgts, dtype=np.float64)
    factor = m / (m - 1.0)
    B, n, _ = Gb.shape
    cov = jnp.zeros((B, n, n), dtype=jnp.float64)
    mimj = jnp.zeros((B, n, n), dtype=jnp.float64)
    mi = jnp.zeros((B, n), dtype=jnp.float64)
    var = jnp.zeros((B, n), dtype=jnp.float64)
    vmimj = jnp.zeros((B, n), dtype=jnp.float64)
    vmi = jnp.zeros((B, n), dtype=jnp.float64)
    for k in range(len(m)):
        g = Gb[:, :, int(bounds[k]):int(bounds[k + 1])].astype(jnp.float32)
        Ck = jnp.einsum("bns,bms->bnm", g, g,
                        preferred_element_type=jnp.float32).astype(jnp.float64)
        s = jnp.sum(g, axis=2).astype(jnp.float64)
        q = jnp.sum(g * g, axis=2).astype(jnp.float64)
        cov = cov + (w[k] * factor[k]) * (m[k] * Ck - s[:, :, None] * s[:, None, :])
        mimj = mimj + (w[k] * (s / m[k]))[:, :, None] * (s / m[k])[:, None, :]
        mi = mi + w[k] * (s / m[k])
        var = var + (w[k] * factor[k]) * (m[k] * q - s * s)
        vmimj = vmimj + (w[k] * (s / m[k])) * (s / m[k])
        vmi = vmi + w[k] * (s / m[k])
    cov = (cov + mimj) - mi[:, :, None] * mi[:, None, :]
    v = (var + vmimj) - vmi * vmi
    std = jnp.sqrt(v)
    return cov / (std[:, :, None] * std[:, None, :])


@partial(jax.jit, static_argnames=("pop_sizes",))
def _gather_pooled_corr(G_dev, idx, pop_sizes):
    """Gather gene rows from the HBM-resident panel, then pooled corr.
    Padded idx entries gather row 0; their correlations are sliced off
    by the caller (pairwise statistics of real rows are unaffected)."""
    return _batched_pooled_corr(jnp.take(G_dev, idx, axis=0), pop_sizes)


@partial(jax.jit, static_argnames=("pop_sizes", "wgts"))
def _gather_weighted_corr(G_dev, idx, pop_sizes, wgts):
    return _batched_weighted_corr(jnp.take(G_dev, idx, axis=0),
                                  pop_sizes, wgts)


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def gene_corr_matrices(
    gene_G: List[np.ndarray],
    pop_sizes: Sequence[int],
    wgts: Optional[Sequence[float]] = None,
    max_batch_elems: int = 1 << 26,
) -> List[np.ndarray]:
    """Correlation matrix per gene, batched by padded size bucket.

    gene_G: list of [n_g, S] int8 blocks.  Returns float64 [n_g, n_g]
    matrices in the same order.  wgts=None -> pooled CalCor (jepeg);
    otherwise CalWgtCov-based (jepegmix).
    """
    S = gene_G[0].shape[1] if gene_G else 0
    sizes_key = tuple(int(x) for x in pop_sizes)
    wgts_key = tuple(float(x) for x in wgts) if wgts is not None else None
    order = np.argsort([g.shape[0] for g in gene_G], kind="stable")
    out: List[Optional[np.ndarray]] = [None] * len(gene_G)

    i = 0
    while i < len(order):
        npad = _bucket(gene_G[order[i]].shape[0])
        batch_idx = []
        while (i < len(order)
               and _bucket(gene_G[order[i]].shape[0]) == npad
               and (not batch_idx
                    or (len(batch_idx) + 1) * npad * S
                    <= max_batch_elems)):
            batch_idx.append(order[i])
            i += 1
        Gb = np.zeros((len(batch_idx), npad, S), dtype=np.int8)
        for bi, gi in enumerate(batch_idx):
            Gb[bi, :gene_G[gi].shape[0]] = gene_G[gi]
        if wgts_key is None:
            R = np.asarray(_batched_pooled_corr(jnp.asarray(Gb), sizes_key))
        else:
            R = np.asarray(_batched_weighted_corr(jnp.asarray(Gb),
                                                  sizes_key, wgts_key))
        for bi, gi in enumerate(batch_idx):
            n = gene_G[gi].shape[0]
            out[gi] = R[bi, :n, :n]
    return out


def _corr_from_pop_partials(C, S, Q, true_sizes, wgts):
    """Gene correlation matrices from stacked per-pop partial statistics
    C [P, B, n, n] / S [P, B, n] / Q [P, B, n] (exact integers in f32).

    The f64 accumulation loops populations in the same order as
    _batched_weighted_corr, so the unsharded path is bit-identical to it
    and the sharded path (psum'd partials, which are exact integer sums)
    matches to the last bit as well."""
    if wgts is None:
        n = float(sum(int(x) for x in true_sizes))
        C0 = jnp.sum(C, axis=0).astype(jnp.float64)
        s64 = jnp.sum(S, axis=0).astype(jnp.float64)
        q64 = jnp.sum(Q, axis=0).astype(jnp.float64)
        numer = n * C0 - s64[:, :, None] * s64[:, None, :]
        d = jnp.sqrt(n * q64 - s64 * s64)
        return numer / (d[:, :, None] * d[:, None, :])
    m = np.asarray(true_sizes, dtype=np.float64)
    w = np.asarray(wgts, dtype=np.float64)
    factor = m / (m - 1.0)
    B, n = C.shape[1], C.shape[2]
    cov = jnp.zeros((B, n, n), dtype=jnp.float64)
    mimj = jnp.zeros((B, n, n), dtype=jnp.float64)
    mi = jnp.zeros((B, n), dtype=jnp.float64)
    var = jnp.zeros((B, n), dtype=jnp.float64)
    vmimj = jnp.zeros((B, n), dtype=jnp.float64)
    vmi = jnp.zeros((B, n), dtype=jnp.float64)
    for k in range(len(m)):
        Ck = C[k].astype(jnp.float64)
        s = S[k].astype(jnp.float64)
        q = Q[k].astype(jnp.float64)
        cov = cov + (w[k] * factor[k]) * (
            m[k] * Ck - s[:, :, None] * s[:, None, :])
        mimj = mimj + (w[k] * (s / m[k]))[:, :, None] * (s / m[k])[:, None, :]
        mi = mi + w[k] * (s / m[k])
        var = var + (w[k] * factor[k]) * (m[k] * q - s * s)
        vmimj = vmimj + (w[k] * (s / m[k])) * (s / m[k])
        vmi = vmi + w[k] * (s / m[k])
    cov = (cov + mimj) - mi[:, :, None] * mi[:, None, :]
    v = (var + vmimj) - vmi * vmi
    std = jnp.sqrt(v)
    return cov / (std[:, :, None] * std[:, None, :])


def _gene_stats_body(G_dev, idx, Wb, zb, rowmask, bounds, true_sizes,
                     wgts, lam, valid=None, psum=None):
    """Shared core: gather gene rows, per-pop partial stats (psum-able
    across subject shards), f64 CorG with the 1+lambda ridge diagonal
    (src/gene.cpp:569-586), then the category-level contractions
    U = W z, CovU = W CorG W^T, WWt = W W^T (src/gene.cpp:594-648).

    rowmask [B, n] flags each gene's true SNP rows; pad rows gather
    panel row 0, whose correlations can be NaN (zero variance) and
    would poison CovU through 0*NaN in the W contraction -- they are
    zeroed here, reproducing the host-side slice of the dense path.
    NaNs among a gene's REAL SNPs still propagate, matching the
    reference's division by zero (src/util.cpp:63-69).

    Returns (CovU [B, 6, 6], WWt [B, 6, 6], U [B, 6]) float64."""
    Gb = jnp.take(G_dev, idx, axis=0)                    # [B, n, S_loc]
    if valid is not None:
        Gb = Gb * valid[None, None, :]
    g = Gb.astype(jnp.float32)
    Cs, Ss, Qs = [], [], []
    for k in range(len(true_sizes)):
        gk = g[:, :, int(bounds[k]):int(bounds[k + 1])]
        Cs.append(jnp.einsum("bns,bms->bnm", gk, gk,
                             preferred_element_type=jnp.float32))
        Ss.append(jnp.sum(gk, axis=2))
        Qs.append(jnp.sum(gk * gk, axis=2))
    C = jnp.stack(Cs)
    S = jnp.stack(Ss)
    Q = jnp.stack(Qs)
    if psum is not None:
        C, S, Q = psum(C), psum(S), psum(Q)
    CorG = _corr_from_pop_partials(C, S, Q, true_sizes, wgts)
    pairmask = rowmask[:, :, None] * rowmask[:, None, :]
    CorG = jnp.where(pairmask > 0, CorG, 0.0)
    eye = jnp.eye(CorG.shape[1], dtype=CorG.dtype)
    CorG = CorG * (1.0 - eye) + (1.0 + lam) * eye
    WCor = jnp.einsum("bkn,bnm->bkm", Wb, CorG)
    CovU = jnp.einsum("bkm,bjm->bkj", WCor, Wb)
    WWt = jnp.einsum("bkn,bjn->bkj", Wb, Wb)
    U = jnp.einsum("bkn,bn->bk", Wb, zb)
    return CovU, WWt, U


@partial(jax.jit, static_argnames=("pop_sizes", "wgts", "lam"))
def _gene_stats_unsharded(G_dev, idx, Wb, zb, rowmask, pop_sizes, wgts,
                          lam):
    bounds = stats.segment_bounds(pop_sizes)
    return _gene_stats_body(G_dev, idx, Wb, zb, rowmask, bounds,
                            pop_sizes, wgts, lam)


_SHARDED_GENE_FNS = {}


def _gene_stats_sharded_fn(pop_sizes, local_sizes, wgts, lam, mesh):
    """Mesh variant: gene batches data-parallel over the ``window``
    axis, subject axis sharded with one psum of the exact partial
    statistics (the windowed kernels' protocol, parallel/mesh.py).
    The panel must be in subject_shard_layout order."""
    key = (pop_sizes, local_sizes, wgts, lam, mesh)
    fn = _SHARDED_GENE_FNS.get(key)
    if fn is not None:
        return fn
    from jax.sharding import PartitionSpec as P
    from ..parallel.mesh import subject_valid_layout

    n_sub = mesh.shape["subject"]
    valid_np = subject_valid_layout(pop_sizes, n_sub).astype(np.int8)
    bounds = stats.segment_bounds(local_sizes)

    def body(G, idx, Wb, zb, rowmask, valid):
        return _gene_stats_body(
            G, idx, Wb, zb, rowmask, bounds, pop_sizes, wgts, lam,
            valid=valid, psum=lambda x: jax.lax.psum(x, "subject"))

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, "subject"), P("window", None),
                  P("window", None, None), P("window", None),
                  P("window", None), P("subject")),
        out_specs=(P("window", None, None), P("window", None, None),
                   P("window", None)),
    )
    jfn = jax.jit(sharded)
    valid_d = jnp.asarray(valid_np)

    def wrapper(G_dev, idx, Wb, zb, rowmask):
        return jfn(G_dev, idx, Wb, zb, rowmask, valid_d)

    _SHARDED_GENE_FNS[key] = wrapper
    return wrapper


def gene_stats_resident(
    G_dev,
    gene_idx: List[np.ndarray],
    Ws: List[np.ndarray],              # per gene [6, n_g] f64
    zs: List[np.ndarray],              # per gene [n_g] f64
    pop_sizes: Sequence[int],
    wgts: Optional[Sequence[float]] = None,
    lam: float = 0.1,
    mesh=None,
    local_pop_sizes: Optional[Sequence[int]] = None,
    max_batch_elems: int = 1 << 26,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-gene category statistics (CovU [6,6], WWt [6,6], U [6]) with
    the gene SNP blocks gathered from the HBM-resident panel and ALL the
    O(n^2) work batched on-device -- the host keeps only the k<=6
    pruning / chi-square (reference per-gene loop:
    src/jepegmix.cpp:122-139, src/gene.cpp:553-822).

    With ``mesh`` set, gene buckets run data-parallel over the
    ``window`` axis and the subject axis is sharded + psum'd
    (``G_dev`` must then be in subject_shard_layout order with
    ``local_pop_sizes`` the per-shard segment widths)."""
    sizes_key = tuple(int(x) for x in pop_sizes)
    wgts_key = tuple(float(x) for x in wgts) if wgts is not None else None
    S = int(G_dev.shape[1])
    n_win = 1 if mesh is None else mesh.shape["window"]
    order = np.argsort([len(g) for g in gene_idx], kind="stable")
    out: List[Optional[Tuple]] = [None] * len(gene_idx)

    if mesh is not None:
        local_key = tuple(int(x) for x in local_pop_sizes)
        fn = _gene_stats_sharded_fn(sizes_key, local_key, wgts_key,
                                    float(lam), mesh)
    else:
        fn = partial(_gene_stats_unsharded, pop_sizes=sizes_key,
                     wgts=wgts_key, lam=float(lam))

    i = 0
    while i < len(order):
        npad = _bucket(len(gene_idx[order[i]]))
        batch = []
        while (i < len(order)
               and _bucket(len(gene_idx[order[i]])) == npad
               and (not batch
                    or (len(batch) + 1) * npad * S <= max_batch_elems)):
            batch.append(order[i])
            i += 1
        B = -(-len(batch) // n_win) * n_win     # pad batch for the mesh
        idx = np.zeros((B, npad), dtype=np.int32)
        Wb = np.zeros((B, 6, npad))
        zb = np.zeros((B, npad))
        rowmask = np.zeros((B, npad))
        for bi, gi in enumerate(batch):
            n = len(gene_idx[gi])
            idx[bi, :n] = gene_idx[gi]
            Wb[bi, :, :n] = Ws[gi]
            zb[bi, :n] = zs[gi]
            rowmask[bi, :n] = 1.0
        CovU, WWt, U = (np.asarray(a) for a in
                        fn(G_dev, jnp.asarray(idx), jnp.asarray(Wb),
                           jnp.asarray(zb), jnp.asarray(rowmask)))
        for bi, gi in enumerate(batch):
            out[gi] = (CovU[bi], WWt[bi], U[bi])
    return out


def gene_corr_resident(
    G_dev,
    gene_idx: List[np.ndarray],
    pop_sizes: Sequence[int],
    wgts: Optional[Sequence[float]] = None,
    max_batch_elems: int = 1 << 26,
) -> List[np.ndarray]:
    """Correlation matrix per gene, gathered on-device from the
    HBM-resident panel (the decode-once design of SURVEY.md section 7;
    replaces the reference's per-call panel reload,
    src/jepegmix.cpp:65-91).

    G_dev: [R, S] int8 device array (selected-population subject
    columns).  gene_idx: one int row-id vector per gene.  Genes are
    padded into power-of-two buckets and each bucket runs as ONE
    dispatch: gather + batched Gram + f64 combine.  Returns float64
    [n_g, n_g] matrices in input order.
    """
    sizes_key = tuple(int(x) for x in pop_sizes)
    wgts_key = tuple(float(x) for x in wgts) if wgts is not None else None
    S = int(G_dev.shape[1])
    order = np.argsort([len(g) for g in gene_idx], kind="stable")
    out: List[Optional[np.ndarray]] = [None] * len(gene_idx)

    i = 0
    while i < len(order):
        npad = _bucket(len(gene_idx[order[i]]))
        batch = []
        while (i < len(order)
               and _bucket(len(gene_idx[order[i]])) == npad
               and (not batch
                    or (len(batch) + 1) * npad * S <= max_batch_elems)):
            batch.append(order[i])
            i += 1
        idx = np.zeros((len(batch), npad), dtype=np.int32)
        for bi, gi in enumerate(batch):
            idx[bi, :len(gene_idx[gi])] = gene_idx[gi]
        if wgts_key is None:
            R = np.asarray(_gather_pooled_corr(G_dev, jnp.asarray(idx),
                                               sizes_key))
        else:
            R = np.asarray(_gather_weighted_corr(G_dev, jnp.asarray(idx),
                                                 sizes_key, wgts_key))
        for bi, gi in enumerate(batch):
            n = len(gene_idx[gi])
            out[gi] = R[bi, :n, :n]
    return out
