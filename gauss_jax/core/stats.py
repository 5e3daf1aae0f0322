"""Correlation/covariance kernels as matmuls over sufficient statistics.

The reference computes every pairwise correlation with scalar loops over
genotype chars (reference: CalCor src/util.cpp:49-70, CalWgtCov
src/util.cpp:103-124, per-string CalCor src/util.cpp:153-169, CalCorSup
src/zmix.cpp:1221-1246).  All of those formulas are functions of
per-population *sufficient statistics*:

    S_k[i]    = sum_j G_k[i, j]          (allele-count row sums)
    Q_k[i]    = sum_j G_k[i, j]^2
    C_k[i,i'] = sum_j G_k[i, j] G_k[i', j]   (cross products = G_k G_k^T)

Because dosages are in {0,1,2} and panels have < 4M subjects per
population, every one of these is an integer < 2^24 -- which means a
float32 matmul computes them EXACTLY, also in TF32 on the GPU's tensor
cores (inputs {0,1,2} are exact in TF32, and it accumulates in f32).  The downstream scalar combinations involve massive
cancellation (m*sum_xy - sum_x*sum_y), so they are evaluated in float64
(native on CPU and GPU -- cheap, O(P*N^2) flops vs
the O(N^2*S) matmuls), reproducing the reference's C++ double arithmetic
term-for-term in the same population order.

Sharding note: every statistic here is a sum over the subject axis, so a
multi-host panel shards subjects/populations across devices and combines
partial (S, Q, C) with psum -- see gauss_jax/parallel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def segment_bounds(pop_sizes: Sequence[int]) -> np.ndarray:
    """Cumulative subject-axis boundaries for population segments."""
    return np.concatenate([[0], np.cumsum(np.asarray(pop_sizes, dtype=np.int64))])


def _f32(x: jnp.ndarray) -> jnp.ndarray:
    return x.astype(jnp.float32)


# ---------------------------------------------------------------------------
# Sufficient statistics (device, exact in f32)
# ---------------------------------------------------------------------------

def pop_cross_products(Ga: jnp.ndarray, Gb: jnp.ndarray,
                       bounds: np.ndarray) -> jnp.ndarray:
    """Per-population cross-product matrices C[P, Na, Nb] = G_ak @ G_bk^T.

    ``bounds`` must be a host-side numpy array (static segmentation).
    Exact integers in float32.
    """
    outs = []
    for k in range(len(bounds) - 1):
        a = _f32(Ga[:, int(bounds[k]):int(bounds[k + 1])])
        b = _f32(Gb[:, int(bounds[k]):int(bounds[k + 1])])
        outs.append(jax.lax.dot_general(
            a, b, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32))
    return jnp.stack(outs)


def pooled_cross_product(Ga: jnp.ndarray, Gb: jnp.ndarray) -> jnp.ndarray:
    """Pooled cross products over ALL subject columns: C[Na, Nb]."""
    return jax.lax.dot_general(
        _f32(Ga), _f32(Gb), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)


def pop_row_stats(G: jnp.ndarray, bounds: np.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-population row sums S[N, P] and squared sums Q[N, P] (exact f32)."""
    Ss, Qs = [], []
    for k in range(len(bounds) - 1):
        g = _f32(G[:, int(bounds[k]):int(bounds[k + 1])])
        Ss.append(jnp.sum(g, axis=1))
        Qs.append(jnp.sum(g * g, axis=1))
    return jnp.stack(Ss, axis=1), jnp.stack(Qs, axis=1)


# ---------------------------------------------------------------------------
# Float64 combines -- reproduce the reference formulas term-for-term.
# ---------------------------------------------------------------------------

def wgt_cov_combine(C: jnp.ndarray, Sa: jnp.ndarray, Sb: jnp.ndarray,
                    m: np.ndarray, w: np.ndarray) -> jnp.ndarray:
    """Weighted covariance matrix, CalWgtCov applied to all pairs.

    Exactly the reference formula (src/util.cpp:103-124), accumulated in
    population order with the same association of products::

        wsumcov   += (w_k * factor_k) * (m_k*sumxy - sumx*sumy)
        wsum_mimj += (w_k * (sumx/m_k)) * (sumy/m_k)
        wsum_mi   += w_k * (sumx/m_k)          (and mj alike)
        result = wsumcov + wsum_mimj - wsum_mi*wsum_mj

    with factor_k = m_k/(m_k-1).

    C: [P, Na, Nb] float32 exact cross products; Sa: [Na, P]; Sb: [Nb, P].
    m, w: host float64 arrays (population sizes / weights, selected pops).
    Returns float64 [Na, Nb].
    """
    P = C.shape[0]
    m = np.asarray(m, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    factor = m / (m - 1.0)
    Na, Nb = C.shape[1], C.shape[2]
    cov = jnp.zeros((Na, Nb), dtype=jnp.float64)
    mimj = jnp.zeros((Na, Nb), dtype=jnp.float64)
    mi = jnp.zeros((Na,), dtype=jnp.float64)
    mj = jnp.zeros((Nb,), dtype=jnp.float64)
    for k in range(P):
        sx = Sa[:, k].astype(jnp.float64)
        sy = Sb[:, k].astype(jnp.float64)
        Ck = C[k].astype(jnp.float64)
        cov = cov + (w[k] * factor[k]) * (m[k] * Ck - sx[:, None] * sy[None, :])
        mimj = mimj + (w[k] * (sx / m[k]))[:, None] * (sy / m[k])[None, :]
        mi = mi + w[k] * (sx / m[k])
        mj = mj + w[k] * (sy / m[k])
    return (cov + mimj) - mi[:, None] * mj[None, :]


def wgt_var_combine(Q: jnp.ndarray, S: jnp.ndarray,
                    m: np.ndarray, w: np.ndarray) -> jnp.ndarray:
    """CalWgtCov(x, x): per-SNP weighted variance.  Q, S: [N, P]."""
    m = np.asarray(m, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    factor = m / (m - 1.0)
    N = Q.shape[0]
    var = jnp.zeros((N,), dtype=jnp.float64)
    mimj = jnp.zeros((N,), dtype=jnp.float64)
    mi = jnp.zeros((N,), dtype=jnp.float64)
    for k in range(Q.shape[1]):
        s = S[:, k].astype(jnp.float64)
        q = Q[:, k].astype(jnp.float64)
        var = var + (w[k] * factor[k]) * (m[k] * q - s * s)
        mimj = mimj + (w[k] * (s / m[k])) * (s / m[k])
        mi = mi + w[k] * (s / m[k])
    return (var + mimj) - mi * mi


def pooled_corr_combine(Cp: jnp.ndarray, Sa: jnp.ndarray, Sb: jnp.ndarray,
                        Qa: jnp.ndarray, Qb: jnp.ndarray,
                        n: float) -> jnp.ndarray:
    """Unweighted pooled Pearson correlation (reference CalCor,
    src/util.cpp:49-70)::

        r = (n*sumxy - sumx*sumy)
            / ( sqrt(n*sumxsq - sumx^2) * sqrt(n*sumysq - sumy^2) )

    Cp: [Na, Nb] pooled cross products; Sa/Qa: [Na] pooled sums/squared
    sums; n = pooled subject count.  Returns float64 [Na, Nb].
    """
    n = float(n)
    sa = Sa.astype(jnp.float64)
    sb = Sb.astype(jnp.float64)
    qa = Qa.astype(jnp.float64)
    qb = Qb.astype(jnp.float64)
    numer = n * Cp.astype(jnp.float64) - sa[:, None] * sb[None, :]
    da = jnp.sqrt(n * qa - sa * sa)
    db = jnp.sqrt(n * qb - sb * sb)
    return numer / (da[:, None] * db[None, :])


def corr_from_cov(cov: jnp.ndarray, std_a: jnp.ndarray,
                  std_b: jnp.ndarray) -> jnp.ndarray:
    """cor = cov / (std_i * std_j), matching the reference's association
    (src/distmix.cpp:195-196)."""
    return cov / (std_a[:, None] * std_b[None, :])


# ---------------------------------------------------------------------------
# Convenience host wrappers
# ---------------------------------------------------------------------------

def per_pop_corr_matrices(G: jnp.ndarray, bounds: np.ndarray) -> jnp.ndarray:
    """Per-population Pearson correlation matrices R[P, N, N], matching the
    per-string CalCor (reference: src/util.cpp:153-169) used by the
    prep_zmix family.  Float64."""
    C = pop_cross_products(G, G, bounds)
    S, Q = pop_row_stats(G, bounds)
    mats = []
    for k in range(C.shape[0]):
        n = float(int(bounds[k + 1]) - int(bounds[k]))
        mats.append(pooled_corr_combine(C[k], S[:, k], S[:, k], Q[:, k], Q[:, k], n))
    return jnp.stack(mats)


def pooled_corr_matrix(Ga: jnp.ndarray, Gb: jnp.ndarray) -> jnp.ndarray:
    """Pooled CalCor over all subject columns of Ga/Gb (concatenated
    populations), as used by dist/qcat/jepeg."""
    Cp = pooled_cross_product(Ga, Gb)
    n = Ga.shape[1]
    one_a = jnp.sum(_f32(Ga), axis=1)
    one_b = jnp.sum(_f32(Gb), axis=1)
    qa = jnp.sum(_f32(Ga) ** 2, axis=1)
    qb = jnp.sum(_f32(Gb) ** 2, axis=1)
    return pooled_corr_combine(Cp, one_a, one_b, qa, qb, float(n))
