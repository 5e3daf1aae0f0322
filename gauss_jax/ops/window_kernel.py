"""Fully-fused batched window kernels for dist/distmix imputation.

This is the device fast path: a batch of fixed-shape (padded + masked)
windows runs stats -> combine -> solve -> imputation entirely on the
accelerator in one jit.  The host-orchestrated API in models/dist.py is
the float64 parity path; this kernel trades the last ~1e-5 of agreement
for zero host round-trips, and is what the genome-scale engine, the
multi-chip shard_map wrapper (gauss_jax/parallel) and the benchmark
drive.

Numerical formulation (matmul-friendly, cancellation-free)
----------------------------------------------------------
The reference's weighted covariance (CalWgtCov, src/util.cpp:103-124) is

    cov(x,y) = sum_k w_k f_k (m_k*Sxy - Sx*Sy)           f_k = m_k/(m_k-1)
             + sum_k w_k xbar_k ybar_k
             - (sum_k w_k xbar_k)(sum_k w_k ybar_k)

The first (dominant) term suffers catastrophic cancellation when
evaluated from raw sufficient statistics in float32, which is why a
naive port needs float64.  We instead use
the algebraic identity  m*Sxy - Sx*Sy = m * sum_s (x_s-xbar)(y_s-ybar)
and evaluate the whole within-population term as ONE matmul over all
subjects:

    big(x,y) = H_x . H_y^T,   H[i,s] = coef_s * (g[i,s] - mu[i,pop(s)])
    coef_s   = sqrt(w_k * m_k^2 / (m_k-1))   for s in population k

Centered values are O(1), so float32 accumulation is stable (no large
means to cancel); it runs as one f32 matmul with Precision.HIGHEST.
The remaining mean-product terms are tiny [N,P] contractions.  The
unweighted pooled CalCor (src/util.cpp:49-70) is the same with a single
pooled mean and coef=1.

Solves: B11 = R + lam*I with R a (weighted) correlation Gram matrix,
which is PSD up to rounding, so min eig(B11) >= lam = 0.1 >> the
MakePosDef clip threshold 1e-5 (src/util.cpp:302-318) -- the clip never
fires and a Cholesky solve is numerically equivalent to the reference's
eigh-clip + LU-inverse.  spec.solver="eigh" keeps the literal
MakePosDef semantics available.

Masking contract (all padding is EXACT, not approximate):
* subject padding: padded columns get coef=0 -> contribute exactly 0 to
  every statistic, while population sizes use the TRUE subject counts.
* SNP padding: masked measured rows get identity rows/cols in B11 and
  zero Z1 entries; masked unmeasured rows emit garbage that callers
  drop via the mask.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import stats

_HI = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class WindowKernelSpec:
    """Static configuration of a compiled window kernel."""

    pop_sizes: Tuple[int, ...]        # TRUE per-pop subject counts
    pop_sizes_padded: Tuple[int, ...]  # per-pop padded segment widths
    wgts: Optional[Tuple[float, ...]]  # None -> unweighted (dist)
    lam: float = 0.1
    min_abs_eig: float = 1e-5
    eig_cutoff: float = 0.01          # CountPC threshold (qcat num_eig)
    solver: str = "cholesky"          # "cholesky" | "eigh" (MakePosDef)
    stats: str = "int8"               # "int8" | "centered" big-term path

    @property
    def bounds(self) -> np.ndarray:
        return stats.segment_bounds(self.pop_sizes_padded)


def pad_pop_segments(G: np.ndarray, pop_sizes: Sequence[int],
                     multiple: int = 1) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Zero-pad each population segment of the subject axis to a multiple
    (for subject-shard divisibility).  Returns (padded G, padded sizes)."""
    bounds = stats.segment_bounds(pop_sizes)
    segs, padded = [], []
    for k in range(len(pop_sizes)):
        seg = G[..., int(bounds[k]):int(bounds[k + 1])]
        m = seg.shape[-1]
        mp = -(-m // multiple) * multiple
        if mp != m:
            pad = [(0, 0)] * (seg.ndim - 1) + [(0, mp - m)]
            seg = np.pad(seg, pad)
        segs.append(seg)
        padded.append(mp)
    return np.concatenate(segs, axis=-1), tuple(padded)


def subject_static_arrays(spec: WindowKernelSpec
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static per-subject-column arrays for the *unsharded* layout:
    (pop_idx [S] int32, valid [S] f32, onehot [S, P] f32).

    Valid columns are the first ``pop_sizes[k]`` of each padded segment.
    """
    P = len(spec.pop_sizes)
    bounds = spec.bounds
    S = int(bounds[-1])
    pop_idx = np.zeros(S, dtype=np.int32)
    valid = np.zeros(S, dtype=np.float32)
    for k in range(P):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        pop_idx[lo:hi] = k
        valid[lo:lo + int(spec.pop_sizes[k])] = 1.0
    onehot = np.zeros((S, P), dtype=np.float32)
    onehot[np.arange(S), pop_idx] = valid
    return pop_idx, valid, onehot


def _center_coef(spec: WindowKernelSpec, pop_idx: np.ndarray,
                 valid) -> jnp.ndarray:
    """Per-subject coefficient sqrt(w_k m_k^2/(m_k-1)) (weighted) or 1
    (pooled), zeroed on padded columns.  ``valid`` may be traced."""
    if spec.wgts is not None:
        m = np.asarray(spec.pop_sizes, dtype=np.float64)
        w = np.asarray(spec.wgts, dtype=np.float64)
        alpha = np.sqrt(w * m * m / (m - 1.0)).astype(np.float32)
        base = alpha[pop_idx]
    else:
        base = np.ones(len(pop_idx), dtype=np.float32)
    return jnp.asarray(base) * valid


def _pop_sums(G_f, onehot):
    """Exact per-pop row sums S[W, N, P] via one matmul (integers
    < 2^24 are exact in f32 regardless of pass precision)."""
    return jnp.einsum("wns,sp->wnp", G_f, onehot,
                      preferred_element_type=jnp.float32)


def _centered(G_f, mu, pop_idx, coef):
    """H[w,n,s] = coef_s * (g - mu[w,n,pop(s)])."""
    mu_s = jnp.take(mu, jnp.asarray(pop_idx), axis=2)
    return (G_f - mu_s) * coef[None, None, :]


def _int_gram(a, b, dn):
    """Exact int32 dot_general of int8 blocks.

    XLA's s8 x s8 -> s32 GEMM on the GPU returned wrong sums whenever
    the contraction length K was not a multiple of 4 (H100, jax 0.9:
    K = 2..15 at 64 output columns, K up to 79 at 5 columns; every
    multiple of 4 exact).  Zero-padding K to a multiple of 4 is exact
    and keeps the int8 rate."""
    (ca,), (cb,) = dn[0]
    pad = -a.shape[ca] % 4
    if pad:
        a = jnp.pad(a, [(0, pad * (i == ca)) for i in range(a.ndim)])
        b = jnp.pad(b, [(0, pad * (i == cb)) for i in range(b.ndim)])
    return jax.lax.dot_general(a, b, dn, preferred_element_type=jnp.int32)


def _int8_weighted_stats(Gm, Gu, spec: WindowKernelSpec):
    """Exact int8 evaluation of the dominant weighted-covariance term.

    Per population k (static segment bounds), the un-normalized
    within-pop term of CalWgtCov (src/util.cpp:103-124) is

        d_k = m_k * (G_k G_k^T) - S_k S_k^T        (m^2 * cov)

    Dosages are {0,1,2}, so with m_k <= 2^13 subjects per population
    every quantity is an integer < 2^31: the int8 Gram matrix,
    the scalar multiply and the outer-product subtraction are all EXACT
    in int32.  Only the final weighted f32 accumulation across the <=29
    populations rounds, giving ~1e-7 correlation-scale error -- both
    faster (int8 tensor-core rate) and ~30x more accurate than the centered
    f32 matmul path, which this replaces on single-device runs.
    (The sharded path keeps the centered formulation: d_k is not
    additive across subject shards, psum-able sufficient statistics
    are.)

    Returns (big_mm [W,M,M] f32, big_um [W,U,M] f32, vu_big [W,U] f32,
    S_m [W,M,P] f32, S_u [W,U,P] f32) where big_* already carry the
    w_k * m_k/(m_k-1) weights, matching the centered path's outputs.
    """
    bounds = spec.bounds
    P = len(spec.pop_sizes)
    m = np.asarray(spec.pop_sizes, dtype=np.float64)
    w = np.asarray(spec.wgts, dtype=np.float64)
    alpha = (w * m / (m - 1.0)).astype(np.float32)
    W, Mp, _ = Gm.shape
    Up = Gu.shape[1]
    big_mm = jnp.zeros((W, Mp, Mp), jnp.float32)
    big_um = jnp.zeros((W, Up, Mp), jnp.float32)
    vu_big = jnp.zeros((W, Up), jnp.float32)
    Sm_l, Su_l = [], []
    dn = (((2,), (2,)), ((0,), (0,)))   # contract subjects, batch windows
    for k in range(P):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        a = Gm[:, :, lo:hi]
        b = Gu[:, :, lo:hi]
        mk = int(spec.pop_sizes[k])
        Cmm = _int_gram(a, a, dn)
        Cum = _int_gram(b, a, dn)
        Sm = jnp.sum(a.astype(jnp.int32), axis=2)          # [W, Mp]
        Su = jnp.sum(b.astype(jnp.int32), axis=2)
        Qu = jnp.sum((b * b).astype(jnp.int32), axis=2)
        d_mm = mk * Cmm - Sm[:, :, None] * Sm[:, None, :]  # exact int32
        d_um = mk * Cum - Su[:, :, None] * Sm[:, None, :]
        d_uu = mk * Qu - Su * Su
        big_mm = big_mm + alpha[k] * d_mm.astype(jnp.float32)
        big_um = big_um + alpha[k] * d_um.astype(jnp.float32)
        vu_big = vu_big + alpha[k] * d_uu.astype(jnp.float32)
        Sm_l.append(Sm)
        Su_l.append(Su)
    S_m = jnp.stack(Sm_l, axis=2).astype(jnp.float32)      # [W, Mp, P]
    S_u = jnp.stack(Su_l, axis=2).astype(jnp.float32)
    return big_mm, big_um, vu_big, S_m, S_u


def _pallas_weighted_stats(Gm, Gu, spec: WindowKernelSpec):
    """Fused-Pallas evaluation of the weighted big term (see
    ops/pallas_gram.py).  Same contract as _int8_weighted_stats.

    Exactness scheme: per-(SNP, population) integer shifts
    c = round(mean dosage) are subtracted from the dosages first
    (covariance is shift-invariant, the int identity
    m*C' - S'S'^T = m*C - SS^T is exact), which keeps both the fused
    T1' = sum beta_k C'_k and the rank-P correction T2' at the scale of
    the RESULT, so the f32 subtraction loses nothing to cancellation
    even for low-variance SNPs.
    """
    from . import pallas_gram as pg

    bounds = spec.bounds
    P = len(spec.pop_sizes)
    m = np.asarray(spec.pop_sizes, dtype=np.float64)
    w = np.asarray(spec.wgts, dtype=np.float64)
    alpha = jnp.asarray((w * m / (m - 1.0)).astype(np.float32))
    m_i32 = jnp.asarray(np.asarray(spec.pop_sizes, dtype=np.int32))
    W, Mp, S = Gm.shape
    Up = Gu.shape[1]

    # static per-column arrays over the padded subject layout
    pop_idx = np.zeros(S, dtype=np.int32)
    valid = np.zeros(S, dtype=np.int8)
    onehot = np.zeros((S, P), dtype=np.int8)
    for k in range(P):
        lo = int(bounds[k])
        mk = int(spec.pop_sizes[k])
        pop_idx[lo:lo + int(spec.pop_sizes_padded[k])] = k
        valid[lo:lo + mk] = 1
        onehot[lo:lo + mk, k] = 1
    onehot_d = jnp.asarray(onehot)
    valid_d = jnp.asarray(valid)
    pop_idx_d = jnp.asarray(pop_idx)

    dn = (((2,), (1,)), ((0,), (0,)))    # contract subjects, batch windows
    oh = jnp.broadcast_to(onehot_d, (W, S, P))
    S_m = jax.lax.dot_general(Gm, oh, dn, preferred_element_type=jnp.int32)
    S_u = jax.lax.dot_general(Gu, oh, dn, preferred_element_type=jnp.int32)
    Q_u = jax.lax.dot_general(Gu * Gu, oh, dn,
                              preferred_element_type=jnp.int32)

    # integer shifts c in {0,1,2}; exact int32 arithmetic throughout
    mf = jnp.asarray(m.astype(np.float32))
    c_m = jnp.clip(jnp.round(S_m.astype(jnp.float32) / mf), 0, 2
                   ).astype(jnp.int32)                       # [W, Mp, P]
    c_u = jnp.clip(jnp.round(S_u.astype(jnp.float32) / mf), 0, 2
                   ).astype(jnp.int32)
    Sp_m = S_m - m_i32 * c_m                                 # shifted sums
    Sp_u = S_u - m_i32 * c_u

    def shift(G, c):
        cs = jnp.take(c.astype(jnp.int8), pop_idx_d, axis=2)  # [W, N, S]
        return (G - cs) * valid_d[None, None, :]

    # every window's Grams in one call each: the gathered [W, N, S]
    # blocks are consecutive bands of their [W*N, S] flattening
    Xm = shift(Gm, c_m).reshape(W * Mp, S)
    Xu = shift(Gu, c_u).reshape(W * Up, S)
    m_t0 = jnp.arange(W, dtype=jnp.int32) * (Mp // pg.ROW_TILE)
    u_t0 = jnp.arange(W, dtype=jnp.int32) * (Up // pg.ROW_TILE)
    t1_mm = pg.weighted_gram_t1(Xm, Xm, spec.pop_sizes,
                                spec.pop_sizes_padded, spec.wgts,
                                n_sym=Mp // pg.BLOCK, nx=Mp, ny=Mp,
                                x_tile0=m_t0, y_tile0=m_t0)
    t1_um = pg.weighted_gram_t1(Xu, Xm, spec.pop_sizes,
                                spec.pop_sizes_padded, spec.wgts,
                                nx=Up, ny=Mp, x_tile0=u_t0, y_tile0=m_t0)
    # shifted sums |S'| <= m/2, so these f32 products are exact for
    # m <= 8192 and ~6e-8 relative above; HIGHEST keeps the GPU from
    # running this small rank-P correction in TF32.
    sx = Sp_m.astype(jnp.float32)                             # [W, Mp, P]
    su = Sp_u.astype(jnp.float32)
    t2_mm = jnp.einsum("wmp,wnp->wmn", sx * alpha, sx, precision=_HI,
                       preferred_element_type=jnp.float32)
    t2_um = jnp.einsum("wup,wmp->wum", su * alpha, sx, precision=_HI,
                       preferred_element_type=jnp.float32)
    big_mm = pg.mirror_lower(t1_mm) - t2_mm
    big_um = t1_um - t2_um

    d_uu = m_i32 * Q_u - S_u * S_u                           # exact int32
    vu_big = jnp.dot(d_uu.astype(jnp.float32), alpha, precision=_HI)
    return big_mm, big_um, vu_big, S_m.astype(jnp.float32), \
        S_u.astype(jnp.float32)


def _int8_sharded_weighted_stats(Gm, Gu, spec: WindowKernelSpec,
                                 axis_name: str, subject_valid):
    """Subject-sharded variant of the int8-exact weighted stats
    (distmix CalWgtCov big term, src/util.cpp:103-124).

    The per-pop combination d_k = m_k*C_k - S_k S_k^T is NOT additive
    across subject shards, but the raw sufficient statistics (Gram C_k,
    sums S_k, Q_k) are.  Protocol:

      1. psum the exact int32 per-pop row sums -> global S; integer
         shifts c = round(mean) are then identical on every shard;
      2. each shard forms locally-shifted int8 dosages (values in
         [-2, 2]) and its exact int32 per-pop Grams; the f32
         beta_k-weighted local combination T1^(s) is additive -> ONE
         [*, M] f32 psum (vs P exact int32 Gram psums, which would be
         P times the NVLink traffic);
      3. the rank-P correction T2 comes from the global shifted sums,
         computed identically on every shard.

    Shifting puts T1/T2 at RESULT scale (see _pallas_weighted_stats),
    so the f32 psum rounds at ~1e-7 relative of the result -- the
    sharded path matches the single-device int8 path to f32 noise
    instead of the centered path's ~1e-5.

    ``Gu`` may be None (symmetric LD case).  Returns the same tuple
    contract as _int8_weighted_stats (with None entries when Gu is
    None).
    """
    bounds = spec.bounds                      # LOCAL segment bounds
    P = len(spec.pop_sizes)
    m = np.asarray(spec.pop_sizes, dtype=np.float64)
    w = np.asarray(spec.wgts, dtype=np.float64)
    alpha = jnp.asarray((w * m / (m - 1.0)).astype(np.float32))
    beta = jnp.asarray((w * m * m / (m - 1.0)).astype(np.float32))
    m_i32 = jnp.asarray(m.astype(np.int32))
    W, Mp, S = Gm.shape
    psum = lambda x: jax.lax.psum(x, axis_name)

    pop_idx = np.zeros(S, dtype=np.int32)
    for k in range(P):
        pop_idx[int(bounds[k]):int(bounds[k + 1])] = k
    pop_idx_d = jnp.asarray(pop_idx)
    valid_i = subject_valid.astype(jnp.int32)
    oh = (jax.nn.one_hot(pop_idx_d, P, dtype=jnp.int32)
          * valid_i[:, None])                                 # [S, P]

    def pop_sums_i32(G):
        return psum(_int_gram(G, oh.astype(jnp.int8),
                              (((2,), (0,)), ((), ()))))

    S_m = pop_sums_i32(Gm)                                    # exact int32
    mf = jnp.asarray(m.astype(np.float32))
    c_m = jnp.clip(jnp.round(S_m.astype(jnp.float32) / mf), 0, 2
                   ).astype(jnp.int32)
    Sp_m = S_m - m_i32 * c_m

    def shift(G, c):
        cs = jnp.take(c.astype(jnp.int8), pop_idx_d, axis=2)
        return (G - cs) * subject_valid.astype(jnp.int8)[None, None, :]

    Gm_c = shift(Gm, c_m)
    dn = (((2,), (2,)), ((0,), (0,)))   # contract subjects, batch windows
    big_mm = jnp.zeros((W, Mp, Mp), jnp.float32)
    for k in range(P):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        a = Gm_c[:, :, lo:hi]
        Cmm = _int_gram(a, a, dn)
        big_mm = big_mm + beta[k] * Cmm.astype(jnp.float32)
    sxm = Sp_m.astype(jnp.float32)
    t2_mm = jnp.einsum("wmp,p,wnp->wmn", sxm, alpha, sxm,
                       precision=_HI, preferred_element_type=jnp.float32)
    big_mm = psum(big_mm) - t2_mm

    if Gu is None:
        return big_mm, None, None, S_m.astype(jnp.float32), None

    Up = Gu.shape[1]
    S_u = pop_sums_i32(Gu)
    Q_u = pop_sums_i32(Gu * Gu)
    c_u = jnp.clip(jnp.round(S_u.astype(jnp.float32) / mf), 0, 2
                   ).astype(jnp.int32)
    Sp_u = S_u - m_i32 * c_u
    Gu_c = shift(Gu, c_u)
    big_um = jnp.zeros((W, Up, Mp), jnp.float32)
    for k in range(P):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        a = Gm_c[:, :, lo:hi]
        b = Gu_c[:, :, lo:hi]
        Cum = _int_gram(b, a, dn)
        big_um = big_um + beta[k] * Cum.astype(jnp.float32)
    sxu = Sp_u.astype(jnp.float32)
    t2_um = jnp.einsum("wup,p,wmp->wum", sxu, alpha, sxm,
                       precision=_HI, preferred_element_type=jnp.float32)
    big_um = psum(big_um) - t2_um

    # d_uu from GLOBAL exact int32 stats: identical to the 1-dev value
    d_uu = m_i32 * Q_u - S_u * S_u
    vu_big = jnp.dot(d_uu.astype(jnp.float32), jnp.asarray(
        (w * m / (m - 1.0)).astype(np.float32)), precision=_HI)
    return big_mm, big_um, vu_big, S_m.astype(jnp.float32), \
        S_u.astype(jnp.float32)


def _weighted_mm_stats(Gm, spec: WindowKernelSpec):
    """Symmetric-only variant of the weighted stats: returns
    (big_mm [W, Mp, Mp] f32, S_m [W, Mp, P] f32).  Uses the Pallas
    triangle kernel when eligible, else the exact XLA int8 loop."""
    bounds = spec.bounds
    P = len(spec.pop_sizes)
    m = np.asarray(spec.pop_sizes, dtype=np.float64)
    w = np.asarray(spec.wgts, dtype=np.float64)
    alpha_np = (w * m / (m - 1.0)).astype(np.float32)
    W, Mp, S = Gm.shape

    if spec.stats == "pallas" and _pallas_ok(spec, Mp, Mp):
        from . import pallas_gram as pg
        pop_idx = np.zeros(S, dtype=np.int32)
        valid = np.zeros(S, dtype=np.int8)
        for k in range(P):
            lo = int(bounds[k])
            pop_idx[lo:lo + int(spec.pop_sizes_padded[k])] = k
            valid[lo:lo + int(spec.pop_sizes[k])] = 1
        oh = np.zeros((S, P), dtype=np.int8)
        for k in range(P):
            lo = int(bounds[k])
            oh[lo:lo + int(spec.pop_sizes[k]), k] = 1
        dn = (((2,), (1,)), ((0,), (0,)))
        S_m = jax.lax.dot_general(
            Gm, jnp.broadcast_to(jnp.asarray(oh), (W, S, P)), dn,
            preferred_element_type=jnp.int32)
        mf = jnp.asarray(m.astype(np.float32))
        c_m = jnp.clip(jnp.round(S_m.astype(jnp.float32) / mf), 0, 2
                       ).astype(jnp.int32)
        Sp_m = S_m - jnp.asarray(m.astype(np.int32)) * c_m
        cs = jnp.take(c_m.astype(jnp.int8), jnp.asarray(pop_idx), axis=2)
        Xm = ((Gm - cs) * jnp.asarray(valid)[None, None, :]
              ).reshape(W * Mp, S)
        m_t0 = jnp.arange(W, dtype=jnp.int32) * (Mp // pg.ROW_TILE)
        t1 = pg.weighted_gram_t1(Xm, Xm, spec.pop_sizes,
                                 spec.pop_sizes_padded, spec.wgts,
                                 n_sym=Mp // pg.BLOCK, nx=Mp, ny=Mp,
                                 x_tile0=m_t0, y_tile0=m_t0)
        sx = Sp_m.astype(jnp.float32)
        t2 = jnp.einsum("wmp,wnp->wmn", sx * jnp.asarray(alpha_np), sx,
                        precision=_HI, preferred_element_type=jnp.float32)
        return pg.mirror_lower(t1) - t2, S_m.astype(jnp.float32)

    # exact XLA int8 fallback (per-pop d_k, see _int8_weighted_stats)
    big_mm = jnp.zeros((W, Mp, Mp), jnp.float32)
    Sm_l = []
    dn = (((2,), (2,)), ((0,), (0,)))
    for k in range(P):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        a = Gm[:, :, lo:hi]
        mk = int(spec.pop_sizes[k])
        Cmm = _int_gram(a, a, dn)
        Sm = jnp.sum(a.astype(jnp.int32), axis=2)
        d_mm = mk * Cmm - Sm[:, :, None] * Sm[:, None, :]
        big_mm = big_mm + alpha_np[k] * d_mm.astype(jnp.float32)
        Sm_l.append(Sm)
    return big_mm, jnp.stack(Sm_l, axis=2).astype(jnp.float32)


def window_corr(Gm, m_mask, spec: WindowKernelSpec,
                axis_name: Optional[str] = None,
                subject_valid: Optional[jnp.ndarray] = None):
    """Batched weighted correlation matrix of a window's measured SNPs
    (computeLD semantics: src/computeLD.cpp:104-116 -- diag forced to
    1.0, NO ridge).  Gm: [W, Mp, S] int8, m_mask: [W, Mp].
    Returns corr [W, Mp, Mp] f32 with identity rows on masked SNPs.
    With ``axis_name`` the subject axis is sharded: psum-able centered
    sufficient statistics replace the int8/Pallas Gram paths.
    """
    if spec.wgts is None:
        raise ValueError("window_corr implements the weighted "
                         "(computeLD) estimator; use pooled_corr for "
                         "the unweighted case")
    m = np.asarray(spec.pop_sizes, dtype=np.float64)
    W, Mp, S = Gm.shape

    if axis_name is None:
        big_mm, S_m = _weighted_mm_stats(Gm, spec)
    elif spec.stats in ("int8", "pallas") and max(spec.pop_sizes) <= 23000:
        pop_idx, valid_np, _ = subject_static_arrays(spec)
        valid = (jnp.asarray(valid_np) if subject_valid is None
                 else subject_valid)
        big_mm, _, _, S_m, _ = _int8_sharded_weighted_stats(
            Gm, None, spec, axis_name, valid)
    else:
        pop_idx, valid_np, _ = subject_static_arrays(spec)
        valid = (jnp.asarray(valid_np) if subject_valid is None
                 else subject_valid)
        coef = _center_coef(spec, pop_idx, valid)
        onehot = jax.nn.one_hot(jnp.asarray(pop_idx), len(spec.pop_sizes),
                                dtype=jnp.float32) * valid[:, None]
        psum = lambda x: jax.lax.psum(x, axis_name)
        Gm_f = Gm.astype(jnp.float32)
        S_m = psum(_pop_sums(Gm_f, onehot))
        mu = S_m / jnp.asarray(m, dtype=jnp.float32)
        Hm = _centered(Gm_f, mu, pop_idx, coef)
        big_mm = psum(jnp.einsum("wms,wns->wmn", Hm, Hm, precision=_HI,
                                 preferred_element_type=jnp.float32))
    mu_m = S_m / jnp.asarray(m, dtype=jnp.float32)

    w = jnp.asarray(np.asarray(spec.wgts, dtype=np.float64),
                    dtype=jnp.float32)
    mi_m = jnp.dot(mu_m, w, precision=_HI)
    mimj = jnp.einsum("wmp,p,wnp->wmn", mu_m, w, mu_m, precision=_HI)
    cov = (big_mm + mimj) - mi_m[:, :, None] * mi_m[:, None, :]
    var = jnp.einsum("wii->wi", cov)
    std = jnp.sqrt(jnp.where(m_mask > 0, var, 1.0))
    corr = cov / (std[:, :, None] * std[:, None, :])
    mm = (m_mask[:, :, None] * m_mask[:, None, :]).astype(corr.dtype)
    corr = corr * mm
    eye = jnp.eye(Mp, dtype=corr.dtype)
    return corr * (1.0 - eye) + eye


LD_I16_SCALE = 32767.0
#: quantization bound of the int16 triangle fetch: 0.5/32767 from the
#: round-to-int plus the f32 rounding of corr*32767 (|corr| <= 1, so
#: that product rounds within 32767 * 2^-24 < 0.002 units)
LD_I16_MAX_ERR = 0.502 / LD_I16_SCALE
#: int16 NaN sentinel (outside the [-32767, 32767] clip range): the
#: NaN-propagation contract for zero-variance SNPs (README deviations)
#: survives quantized fetches -- astype(int) of NaN is implementation-
#: defined, so NaN is encoded explicitly and restored by the unpackers
LD_I16_NAN = -32768


def _quant_i16(corr):
    """[-1, 1] -> int16 fixed point, NaN -> LD_I16_NAN sentinel."""
    q = jnp.clip(jnp.round(corr * LD_I16_SCALE),
                 -LD_I16_SCALE, LD_I16_SCALE)
    return jnp.where(jnp.isnan(corr), np.float32(LD_I16_NAN), q
                     ).astype(jnp.int16)


def _dequant_i16(raw_i16: np.ndarray) -> np.ndarray:
    """Host inverse of _quant_i16 (float64, sentinel -> NaN)."""
    out = np.asarray(raw_i16, dtype=np.float64) / LD_I16_SCALE
    out[np.asarray(raw_i16) == LD_I16_NAN] = np.nan
    return out


def pack_tri_i16(corr):
    """Device-side LD fetch compression: correlations live in [-1, 1]
    and the matrix is symmetric, so fetch the lower triangle as int16
    fixed-point -- 1/8 the bytes of the full f32 matrix, with
    |dr| <= LD_I16_MAX_ERR ~ 1.5e-5 (below the f32-vs-f64 stats noise
    at 33k subjects).  The diagonal is exactly 1.0 both ways (the
    kernel forces it; 32767/32767 == 1).  NaN correlations
    (zero-variance SNPs) round-trip via the LD_I16_NAN sentinel."""
    Mp = corr.shape[-1]
    ti, tj = np.tril_indices(Mp)
    q = _quant_i16(corr)
    return q[..., ti, tj]                     # [..., Mp*(Mp+1)//2]


#: row-block height of the block-triangle packing
TRI_BLOCK = 128


def pack_block_tri_i16(corr: jnp.ndarray) -> jnp.ndarray:
    """Block-triangle int16 packing of a symmetric [..., SL, SL]
    matrix: row-block b (TRI_BLOCK rows) keeps its leading
    TRI_BLOCK*(b+1) columns -- the lower triangle at block granularity
    (~SL*TRI_BLOCK/2 elements of overhead vs the exact triangle).  Pure
    static slices: the exact-triangle GATHER both compiles
    pathologically inside window scans (>25 min) and runs slowly; this
    is reshape+concat.  SL must be a TRI_BLOCK multiple; leading batch
    dims pass through."""
    SL = corr.shape[-1]
    lead = corr.shape[:-2]
    q = _quant_i16(corr)
    parts = []
    for b in range(SL // TRI_BLOCK):
        w = TRI_BLOCK * (b + 1)
        parts.append(q[..., TRI_BLOCK * b:TRI_BLOCK * (b + 1), :w]
                     .reshape(lead + (-1,)))
    return jnp.concatenate(parts, axis=-1)


def block_tri_len(SL: int) -> int:
    nb = SL // TRI_BLOCK
    return TRI_BLOCK * TRI_BLOCK * nb * (nb + 1) // 2


def unpack_block_tri_i16(flat: np.ndarray, SL: int, M: int) -> np.ndarray:
    """Host inverse of pack_block_tri_i16 restricted to the leading
    [M, M] block; float64 symmetric matrix."""
    out = np.zeros((SL, SL))
    off = 0
    for b in range(SL // TRI_BLOCK):
        w = TRI_BLOCK * (b + 1)
        n = TRI_BLOCK * w
        blk = _dequant_i16(np.asarray(flat[off:off + n])
                           ).reshape(TRI_BLOCK, w)
        out[TRI_BLOCK * b:TRI_BLOCK * (b + 1), :w] = blk
        off += n
    # mirror the strictly-upper BLOCKS (the diagonal blocks are stored
    # in full, so only columns beyond each row-block's width are absent)
    for b in range(SL // TRI_BLOCK):
        w = TRI_BLOCK * (b + 1)
        out[TRI_BLOCK * b:TRI_BLOCK * (b + 1), w:] = \
            out[w:, TRI_BLOCK * b:TRI_BLOCK * (b + 1)].T
    return out[:M, :M]


def unpack_tri_i16(tri: np.ndarray, Mp: int, M: int) -> np.ndarray:
    """Host-side inverse of pack_tri_i16 restricted to the leading
    M x M block: float64 symmetric matrix."""
    ti, tj = np.tril_indices(Mp)
    keep = (ti < M) & (tj < M)
    out = np.zeros((M, M))
    vals = _dequant_i16(np.asarray(tri)[keep])
    out[ti[keep], tj[keep]] = vals
    out = out + out.T
    out[np.diag_indices(M)] /= 2.0
    return out


def build_gather_ld_kernel(spec: WindowKernelSpec, fetch: str = "f32"):
    """Jitted (G_dev [R, S] int8, m_idx [W, Mp] i32, m_mask [W, Mp]) ->
    LD output with the panel resident in HBM.  ``fetch``: "f32" returns
    the full corr [W, Mp, Mp]; "i16tri" returns the packed int16 lower
    triangle [W, Mp*(Mp+1)//2] (see pack_tri_i16) -- the dense cormat
    fetch dominates the host link on computeLD workloads
    (src/computeLD.cpp:104-116 is the corr; the fetch is ours)."""
    @jax.jit
    def fn(G_dev, m_idx, m_mask):
        Gm = jnp.take(G_dev, m_idx, axis=0)
        corr = window_corr(Gm, m_mask, spec)
        return pack_tri_i16(corr) if fetch == "i16tri" else corr

    return fn


def _pallas_ok(spec: WindowKernelSpec, Mp: int, Up: int) -> bool:
    from . import pallas_gram as pg
    # off the GPU the XLA int8 path (_int8_weighted_stats) is the same
    # computation without the shift/band bookkeeping
    return (spec.wgts is not None
            and pg.use_kernel()
            and max(spec.pop_sizes) <= 23000
            and Mp % pg.ROW_TILE == 0 and Up % pg.ROW_TILE == 0
            and all(sp % pg.K_TILE == 0 for sp in spec.pop_sizes_padded))


def window_corr_blocks(Gm, Gu, m_mask, u_mask, spec: WindowKernelSpec,
                       axis_name: Optional[str] = None,
                       subject_valid: Optional[jnp.ndarray] = None):
    """Batched correlation blocks of a window: B11 [W, Mp, Mp] (ridge
    diagonal 1 + lam, identity rows on masked SNPs) and B21 [W, Up, Mp]
    (masked rows/cols zeroed) in f32.  The stats path (pallas / int8 /
    centered) is chosen per spec.stats and sharding (see module
    docstring)."""
    pop_idx, valid_np, onehot_np = subject_static_arrays(spec)
    valid = jnp.asarray(valid_np) if subject_valid is None else subject_valid
    coef = _center_coef(spec, pop_idx, valid)
    onehot = (jnp.asarray(onehot_np) if subject_valid is None
              else jax.nn.one_hot(jnp.asarray(pop_idx),
                                  len(spec.pop_sizes),
                                  dtype=jnp.float32) * valid[:, None])
    psum = ((lambda x: x) if axis_name is None
            else (lambda x: jax.lax.psum(x, axis_name)))
    # Combines stay in f32: the big centered matmul dominates the error
    # budget (~1e-6 relative), and the small mean-product terms are O(1)
    # magnitudes; the host-orchestrated path (models/dist.py) is the f64
    # parity mode.
    dt = jnp.float32

    Gm_f = Gm.astype(jnp.float32)
    Gu_f = Gu.astype(jnp.float32)

    # int8 exactness bound: 4*m_k^2 must fit int32 (per-pop Gram d-term)
    int8_ok = (spec.stats == "int8" and axis_name is None
               and max(spec.pop_sizes) <= 23000)

    pallas_ok = (spec.stats == "pallas" and axis_name is None
                 and _pallas_ok(spec, Gm.shape[1], Gu.shape[1]))

    sharded_int8_ok = (spec.wgts is not None and axis_name is not None
                       and spec.stats in ("int8", "pallas")
                       and max(spec.pop_sizes) <= 23000)

    if spec.wgts is not None:
        m = np.asarray(spec.pop_sizes, dtype=np.float64)
        w = jnp.asarray(np.asarray(spec.wgts, dtype=np.float64), dtype=dt)
        if sharded_int8_ok:
            big_mm, big_um, vu_big, S_m, S_u = _int8_sharded_weighted_stats(
                Gm, Gu, spec, axis_name, valid)
            mu_m = S_m / jnp.asarray(m, dtype=jnp.float32)
            mu_u = S_u / jnp.asarray(m, dtype=jnp.float32)
        elif pallas_ok:
            big_mm, big_um, vu_big, S_m, S_u = _pallas_weighted_stats(
                Gm, Gu, spec)
            mu_m = S_m / jnp.asarray(m, dtype=jnp.float32)
            mu_u = S_u / jnp.asarray(m, dtype=jnp.float32)
        elif int8_ok or (spec.stats == "pallas" and axis_name is None
                         and max(spec.pop_sizes) <= 23000):
            big_mm, big_um, vu_big, S_m, S_u = _int8_weighted_stats(
                Gm, Gu, spec)
            mu_m = S_m / jnp.asarray(m, dtype=jnp.float32)
            mu_u = S_u / jnp.asarray(m, dtype=jnp.float32)
        else:
            S_m = psum(_pop_sums(Gm_f, onehot))          # [W, Mp, P] exact
            S_u = psum(_pop_sums(Gu_f, onehot))
            mu_m = S_m / jnp.asarray(m, dtype=jnp.float32)
            mu_u = S_u / jnp.asarray(m, dtype=jnp.float32)
            Hm = _centered(Gm_f, mu_m, pop_idx, coef)
            Hu = _centered(Gu_f, mu_u, pop_idx, coef)
            big_mm = psum(jnp.einsum("wms,wns->wmn", Hm, Hm, precision=_HI,
                                     preferred_element_type=jnp.float32))
            big_um = psum(jnp.einsum("wus,wms->wum", Hu, Hm, precision=_HI,
                                     preferred_element_type=jnp.float32))
            vu_big = psum(jnp.sum(Hu * Hu, axis=2))

        # tiny mean-product terms, in the reference's formula (f64 opt.)
        mu_m = mu_m.astype(dt)
        mu_u = mu_u.astype(dt)
        mi_m = jnp.dot(mu_m, w, precision=_HI)        # [W, Mp]
        mi_u = jnp.dot(mu_u, w, precision=_HI)
        mimj_mm = jnp.einsum("wmp,p,wnp->wmn", mu_m, w, mu_m,
                             precision=_HI)
        mimj_um = jnp.einsum("wup,p,wmp->wum", mu_u, w, mu_m,
                             precision=_HI)
        cov_mm = (big_mm.astype(dt) + mimj_mm) - mi_m[:, :, None] * mi_m[:, None, :]
        cov_um = (big_um.astype(dt) + mimj_um) - mi_u[:, :, None] * mi_m[:, None, :]
        var_m = jnp.einsum("wii->wi", cov_mm)
        var_u = ((vu_big.astype(dt) + jnp.einsum("wup,p->wu", mu_u * mu_u, w,
                                                 precision=_HI))
                 - mi_u * mi_u)
    else:
        n = float(sum(spec.pop_sizes))
        s_m = psum(jnp.sum(Gm_f * valid[None, None, :], axis=2))  # [W, Mp]
        s_u = psum(jnp.sum(Gu_f * valid[None, None, :], axis=2))
        mu_m = (s_m / n)[:, :, None]
        mu_u = (s_u / n)[:, :, None]
        Hm = (Gm_f - mu_m) * valid[None, None, :]
        Hu = (Gu_f - mu_u) * valid[None, None, :]
        cov_mm = psum(jnp.einsum("wms,wns->wmn", Hm, Hm, precision=_HI,
                                 preferred_element_type=jnp.float32)).astype(dt)
        cov_um = psum(jnp.einsum("wus,wms->wum", Hu, Hm, precision=_HI,
                                 preferred_element_type=jnp.float32)).astype(dt)
        var_m = jnp.einsum("wii->wi", cov_mm)
        var_u = psum(jnp.sum(Hu * Hu, axis=2)).astype(dt)

    # stds; padded rows have zero variance -> force 1 to stay finite
    std_m = jnp.sqrt(jnp.where(m_mask > 0, var_m, 1.0))
    std_u = jnp.sqrt(jnp.where(u_mask > 0, var_u, 1.0))
    B11 = cov_mm / (std_m[:, :, None] * std_m[:, None, :])
    B21 = cov_um / (std_u[:, :, None] * std_m[:, None, :])

    # mask: identity rows/cols for padded measured SNPs, ridge diagonal
    mm = (m_mask[:, :, None] * m_mask[:, None, :]).astype(B11.dtype)
    B11 = B11 * mm
    eye = jnp.eye(B11.shape[1], dtype=B11.dtype)
    B11 = B11 * (1.0 - eye) + (1.0 + spec.lam) * eye
    B21 = B21 * (u_mask[:, :, None] * m_mask[:, None, :]).astype(B21.dtype)
    return B11.astype(jnp.float32), B21.astype(jnp.float32)


def window_impute(Gm, Gu, Z1, m_mask, u_mask, spec: WindowKernelSpec,
                  axis_name: Optional[str] = None,
                  subject_valid: Optional[jnp.ndarray] = None):
    """Batched dist/distmix imputation.

    Gm: [W, Mp, S] int8, Gu: [W, Up, S] int8, Z1: [W, Mp] f64/f32,
    masks: [W, Mp]/[W, Up] (1 = real SNP).  ``subject_valid`` [S] f32
    overrides the static validity mask (needed under shard_map where
    each shard's padding differs).  Returns (z [W, Up], info [W, Up])
    in f32, garbage where u_mask == 0.
    """
    B11f, B21f = window_corr_blocks(Gm, Gu, m_mask, u_mask, spec,
                                    axis_name=axis_name,
                                    subject_valid=subject_valid)
    if spec.solver == "eigh":
        # literal MakePosDef (eigval clip) + inverse, fused through eigh
        w_eig, v = jnp.linalg.eigh(B11f)
        w_clip = jnp.maximum(w_eig, spec.min_abs_eig)
        B11inv = jnp.einsum("wik,wk,wjk->wij", v, 1.0 / w_clip, v,
                            precision=_HI,
                            preferred_element_type=jnp.float32)
        A = jnp.einsum("wum,wmn->wun", B21f, B11inv, precision=_HI,
                       preferred_element_type=jnp.float32)
    else:
        # B11 = PSD + lam*I  =>  min eig >= lam >> min_abs_eig: the
        # MakePosDef clip is a no-op and Cholesky solves are equivalent.
        # One triangular sweep suffices: with Y = L^-1 B21^T and
        # y1 = L^-1 Z1,  info_i = b_i B11^-1 b_i^T = |Y[:, i]|^2  and
        # z2 = B21 B11^-1 Z1 = Y^T y1 -- half the solve flops of
        # cho_solve's two sweeps (the reference's fabs on info,
        # src/distmix.cpp:224-229, is a no-op on a sum of squares).
        L = jnp.linalg.cholesky(B11f)
        Y = jax.scipy.linalg.solve_triangular(
            L, B21f.transpose(0, 2, 1), lower=True)      # [W, Mp, Up]
        y1 = jax.scipy.linalg.solve_triangular(
            L, Z1.astype(jnp.float32)[:, :, None], lower=True)[:, :, 0]
        z2 = jnp.einsum("wmu,wm->wu", Y, y1, precision=_HI,
                        preferred_element_type=jnp.float32)
        info = jnp.einsum("wmu,wmu->wu", Y, Y, precision=_HI,
                          preferred_element_type=jnp.float32)
        return z2 / jnp.sqrt(info), info
    z2 = jnp.einsum("wum,wm->wu", A, Z1.astype(jnp.float32),
                    precision=_HI, preferred_element_type=jnp.float32)
    info = jnp.abs(jnp.einsum("wum,wum->wu", A, B21f, precision=_HI,
                              preferred_element_type=jnp.float32))
    z = z2 / jnp.sqrt(info)
    return z, info


def _masked_column_corr(Zt, X, mask, n):
    """Pearson correlation of Zt [W, Mp] with each column of X
    [W, Mp, C], over the ``mask``-selected rows only (n = true row
    count per window).  Matches the reference's CalCor on Eigen vectors
    (src/util.cpp:194-203) with padding excluded exactly."""
    Zm = Zt * mask
    Xm = X * mask[:, :, None]
    zbar = jnp.sum(Zm, axis=1, keepdims=True) / n[:, None]
    xbar = jnp.sum(Xm, axis=1) / n[:, None]                  # [W, C]
    szx = jnp.einsum("wm,wmc->wc", Zm, Xm, precision=_HI,
                     preferred_element_type=jnp.float32)
    szz = jnp.sum(Zm * Zm, axis=1, keepdims=True)
    sxx = jnp.einsum("wmc,wmc->wc", Xm, Xm, precision=_HI,
                     preferred_element_type=jnp.float32)
    cov = szx - n[:, None] * zbar * xbar
    vz = szz - n[:, None] * zbar * zbar
    vx = sxx - n[:, None] * xbar * xbar
    return cov / jnp.sqrt(jnp.maximum(vz * vx, 1e-30))


def window_qcat(Gm, Gu, Z1, m_mask, u_mask, spec: WindowKernelSpec,
                axis_name: Optional[str] = None,
                subject_valid: Optional[jnp.ndarray] = None):
    """Batched QCAT tests (reference: run_qcat src/qcat.cpp:134-262,
    run_qcatmix src/qcatmix.cpp:145-286).

    num_eig note: the reference sets num_eig = CountPC(B11, 0.01), but
    B11 = R + lam*I with R PSD and lam = 0.1, so EVERY eigenvalue is
    >= 0.1 > 0.01 and num_eig always equals the measured count M; the
    device path uses M directly (the host path keeps literal CountPC).

    Returns (t_m [W, Mp], chi_m [W, Mp], t_u [W, Up], chi_u [W, Up],
    num_eig [W]); garbage where the masks are 0.
    """
    if spec.lam <= spec.eig_cutoff:
        # num_eig == M only holds when every eigenvalue of R + lam*I
        # clears the CountPC cutoff; otherwise fall back to the host
        # path (models/qcat.py), which runs literal CountPC.
        raise ValueError(
            f"device qcat requires lambda ({spec.lam}) > eig_cutoff "
            f"({spec.eig_cutoff}); use the host qcat path for smaller "
            "ridge values")
    B11f, B21f = window_corr_blocks(Gm, Gu, m_mask, u_mask, spec,
                                    axis_name=axis_name,
                                    subject_valid=subject_valid)
    n = jnp.sum(m_mask, axis=1)                               # = num_eig
    L = jnp.linalg.cholesky(B11f)
    # decorrelate: Zt = L^-1 Z1; Xm = L^-1 B11 (cols = measured SNPs);
    # Xu = L^-1 B21^T  (src/qcat.cpp:204-208,221-246)
    Zt = jax.scipy.linalg.solve_triangular(
        L, Z1.astype(jnp.float32)[:, :, None], lower=True)[:, :, 0]
    Xm = jax.scipy.linalg.solve_triangular(L, B11f, lower=True)
    Xu = jax.scipy.linalg.solve_triangular(L, B21f.transpose(0, 2, 1),
                                           lower=True)
    scale2 = jnp.maximum(n - 3.0, 0.0)
    r_m = _masked_column_corr(Zt, Xm, m_mask, n)
    r_u = _masked_column_corr(Zt, Xu, m_mask, n)
    return (jnp.sqrt(scale2)[:, None] * r_m,
            scale2[:, None] * r_m * r_m,
            jnp.sqrt(scale2)[:, None] * r_u,
            scale2[:, None] * r_u * r_u,
            n)


def build_qcat_region_kernel(spec: WindowKernelSpec):
    """One dispatch for a batch of QCAT windows (see
    build_region_kernel).  Jitted (G_dev, m_idx [W, Mp], u_idx [W, Up],
    Z1, m_mask, u_mask) -> (t_m, chi_m, t_u, chi_u, num_eig)."""
    @jax.jit
    def fn(G_dev, m_idx, u_idx, Z1, m_mask, u_mask):
        W = m_idx.shape[0]
        B = next(b for b in (4, 2, 1) if W % b == 0)

        def body(_, xs):
            mi, ui, z1, mm, um = xs
            Gm = jnp.take(G_dev, mi, axis=0)
            Gu = jnp.take(G_dev, ui, axis=0)
            return None, window_qcat(Gm, Gu, z1, mm, um, spec)

        xs = tuple(a.reshape((W // B, B) + a.shape[1:])
                   for a in (m_idx, u_idx, Z1, m_mask, u_mask))
        _, outs = jax.lax.scan(body, None, xs)
        return tuple(o.reshape((W,) + o.shape[2:]) for o in outs)

    return fn


def build_window_kernel(spec: WindowKernelSpec, axis_name=None):
    """Return a jitted (Gm, Gu, Z1, m_mask, u_mask) -> (z, info) kernel."""
    fn = partial(window_impute, spec=spec, axis_name=axis_name)
    return jax.jit(fn) if axis_name is None else fn


def build_region_kernel(spec: WindowKernelSpec):
    """Whole-region kernel: ONE dispatch imputes a whole batch of
    windows by scanning over them on-device, gathering each window's
    rows from the HBM-resident panel inside the scan body.

    This exists because the per-window dispatch pattern pays the
    host round trip (index upload + z/info fetch + dispatch latency)
    once per window.  Scanning on-device reduces a region to exactly
    one upload, one launch and one fetch.

    Returns jitted (G_dev [R, S] int8, m_idx [W, Mp] i32, u_idx [W, Up]
    i32, Z1 [W, Mp], m_mask [W, Mp], u_mask [W, Up]) -> ONE stacked
    [2, W, Up] f32 array (z, info) -- a single-transfer output, see
    build_resident_region_kernel.  Fully-masked (padding) windows are
    legal: B11 degenerates to (1+lam)*I and the masked outputs are
    dropped by the caller.
    """
    impute = partial(window_impute, spec=spec)

    @jax.jit
    def fn(G_dev, m_idx, u_idx, Z1, m_mask, u_mask):
        W = m_idx.shape[0]
        # several windows per scan step: the batched Cholesky/solves
        # amortize their latency
        B = next(b for b in (4, 2, 1) if W % b == 0)

        def body(_, xs):
            mi, ui, z1, mm, um = xs
            Gm = jnp.take(G_dev, mi, axis=0)
            Gu = jnp.take(G_dev, ui, axis=0)
            return None, impute(Gm, Gu, z1, mm, um)

        xs = tuple(a.reshape((W // B, B) + a.shape[1:])
                   for a in (m_idx, u_idx, Z1, m_mask, u_mask))
        _, (z, info) = jax.lax.scan(body, None, xs)
        return jnp.stack([z.reshape((W,) + z.shape[2:]),
                          info.reshape((W,) + info.shape[2:])])

    return fn


def _slice_rows(A, offs, n: int):
    """Batched [n, C] row slices of A [R, C] at per-window offsets
    ``offs`` [W] (int32 rows)."""
    zero = jnp.zeros((), offs.dtype)
    if A.ndim == 1:
        return jax.vmap(lambda o: jax.lax.dynamic_slice(A, (o,), (n,))
                        )(offs)
    return jax.vmap(lambda o: jax.lax.dynamic_slice(
        A, (o, zero), (n, A.shape[1])))(offs)


def _win_slabs(W: int, cap: int = None) -> int:
    """Windows per batched slab: the whole region when it fits, else
    the largest divisor of W within the cap (W is a window_bucket
    multiple, so a >=4 divisor always exists).  Caps the [W, Mp, Mp]
    HBM temporaries of the batched tail on very long regions."""
    if cap is None:
        cap = int(os.environ.get("GAUSS_WIN_SLAB", 64))
    if W <= cap:
        return W
    return max(d for d in range(1, cap + 1) if W % d == 0)


def _resident_block_builder(spec: WindowKernelSpec, Mp: int, Up: int):
    """Shared core of the resident kernels: per-window (B11, B21)
    correlation blocks streamed from resident panels.

    The gather-based region kernel materializes each window's rows
    with a row gather.  But windows are CONTIGUOUS bp ranges, so after
    partitioning the panel rows into a measured array Xm (type 1,
    bp-sorted) and an unmeasured array Xu (type 0, bp-sorted), every
    window is a contiguous row band of each -- and the Pallas Gram can
    stream those bands straight from HBM via ROW_TILE-aligned block
    offsets (weighted_gram_t1 offset mode).  Nothing is gathered,
    nothing is re-shifted: the integer shifts c = round(mean) are
    per-ROW quantities, so the shifted dosages and all per-row
    statistics are computed ONCE at preparation:

      Xm/Xu  [RM/RU, S] int8   shifted dosages (prepare_resident_panel)
      Spm/Spu [., P]   f32     shifted per-pop row sums S' = S - m*c
      Mum/Muu [., P]   f32     per-pop row means
      Vu      [RU]     f32     sum_k alpha_k (m_k Q_k - S_k^2) per row

    Per window only 5 scalars/vectors cross the host link: the two
    ROW_TILE-unit band offsets, Z1 and the two masks (which also mask
    out the neighbouring windows' rows inside the aligned bands).
    Returns jitted (Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0 [W], u_t0 [W],
    Z1 [W, Mp], m_mask, u_mask) -> (z [W, Up], info [W, Up]).
    Reference cost anchor: /root/reference/src/distmix.cpp:179-236.

    Pooled mode (spec.wgts is None, the homogeneous dist estimator,
    CalCor src/util.cpp:49-70): same streaming structure with the whole
    (padded) subject axis as ONE accumulation group whose weight makes
    the Pallas fold factor beta = w n^2/(n-1) exactly 1.0f, so T1
    degenerates to the plain pooled shifted Gram -- an integer-valued
    f32 accumulation < 2^24, i.e. EXACT -- and the pooled covariance is
    T1 - S'S'^T/n (shift-invariant identity; the shift c = round(pooled
    mean) is constant per row, see prepare_resident_panel).
    """
    from . import pallas_gram as pg

    pooled = spec.wgts is None
    P = len(spec.pop_sizes)
    m = np.asarray(spec.pop_sizes, dtype=np.float64)
    if pooled:
        n = float(m.sum())
        S_pad = int(sum(spec.pop_sizes_padded))
        # one segment over the padded axis; (n-1)/n^2 * n^2/(n-1) == 1
        # to a few f64 ulps -> exactly 1.0 after the f32 cast
        seg_sizes, seg_padded = (int(n),), (S_pad,)
        pw = (float((n - 1.0) / (n * n)),)
        P = 1
    else:
        seg_sizes, seg_padded = spec.pop_sizes, spec.pop_sizes_padded
        pw = spec.wgts
        w64 = np.asarray(spec.wgts, dtype=np.float64)
        alpha = jnp.asarray((w64 * m / (m - 1.0)).astype(np.float32))
        w = jnp.asarray(w64, dtype=jnp.float32)
    R = pg.ROW_TILE

    def blocks(Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0,
               m_mask, u_mask):
        """Batched over a [W] window slab: m_t0/u_t0 are int32 VECTORS
        of ROW_TILE-unit band offsets; returns (B11 [W, Mp, Mp],
        B21 [W, Up, Mp]) f32.  Both Grams run as ONE batched-window
        call each (one program per tile pair and window) -- no
        per-window Python unrolling in the XLA graph, so region
        compiles stay linear in the slab count, and the downstream
        solves see the full [W] batch at once."""
        t1_mm = pg.weighted_gram_t1(
            Xm, Xm, seg_sizes, seg_padded, pw,
            n_sym=Mp // pg.BLOCK, nx=Mp, ny=Mp,
            x_tile0=m_t0, y_tile0=m_t0)                 # [W, Mp, Mp]
        t1_um = pg.weighted_gram_t1(
            Xu, Xm, seg_sizes, seg_padded, pw, nx=Up, ny=Mp,
            x_tile0=u_t0, y_tile0=m_t0)                 # [W, Up, Mp]
        mr = m_t0 * R
        ur = u_t0 * R
        sxm = _slice_rows(Spm, mr, Mp)                  # [W, Mp, P]
        sxu = _slice_rows(Spu, ur, Up)
        vu_big = _slice_rows(Vu, ur, Up)                # [W, Up]
        if pooled:
            # cov = sum_s x'y' - S'x S'y / n  (= sum (x-xbar)(y-ybar))
            t2_mm = jnp.einsum("wmp,wnp->wmn", sxm * (1.0 / n), sxm,
                               precision=_HI,
                               preferred_element_type=jnp.float32)
            t2_um = jnp.einsum("wup,wmp->wum", sxu * (1.0 / n), sxm,
                               precision=_HI,
                               preferred_element_type=jnp.float32)
            cov_mm = pg.mirror_lower(t1_mm) - t2_mm
            cov_um = t1_um - t2_um
            var_m = jnp.diagonal(cov_mm, axis1=1, axis2=2)
            var_u = vu_big
        else:
            mu_m = _slice_rows(Mum, mr, Mp)
            mu_u = _slice_rows(Muu, ur, Up)
            t2_mm = jnp.einsum("wmp,wnp->wmn", sxm * alpha[None, None, :],
                               sxm, precision=_HI,
                               preferred_element_type=jnp.float32)
            t2_um = jnp.einsum("wup,wmp->wum", sxu * alpha[None, None, :],
                               sxm, precision=_HI,
                               preferred_element_type=jnp.float32)
            big_mm = pg.mirror_lower(t1_mm) - t2_mm
            big_um = t1_um - t2_um

            # mean-product terms + normalization (CalWgtCov tail,
            # src/util.cpp:103-124), identical to window_corr_blocks
            mi_m = jnp.dot(mu_m, w, precision=_HI)       # [W, Mp]
            mi_u = jnp.dot(mu_u, w, precision=_HI)
            mimj_mm = jnp.einsum("wmp,p,wnp->wmn", mu_m, w, mu_m,
                                 precision=_HI)
            mimj_um = jnp.einsum("wup,p,wmp->wum", mu_u, w, mu_m,
                                 precision=_HI)
            cov_mm = (big_mm + mimj_mm) \
                - mi_m[:, :, None] * mi_m[:, None, :]
            cov_um = (big_um + mimj_um) \
                - mi_u[:, :, None] * mi_m[:, None, :]
            var_m = jnp.diagonal(cov_mm, axis1=1, axis2=2)
            var_u = (vu_big + jnp.dot(mu_u * mu_u, w, precision=_HI)) \
                - mi_u * mi_u
        std_m = jnp.sqrt(jnp.where(m_mask > 0, var_m, 1.0))
        std_u = jnp.sqrt(jnp.where(u_mask > 0, var_u, 1.0))
        B11 = cov_mm / (std_m[:, :, None] * std_m[:, None, :])
        B21 = cov_um / (std_u[:, :, None] * std_m[:, None, :])
        mm2 = (m_mask[:, :, None] * m_mask[:, None, :]).astype(B11.dtype)
        B11 = B11 * mm2
        eye = jnp.eye(Mp, dtype=B11.dtype)
        B11 = B11 * (1.0 - eye) + (1.0 + spec.lam) * eye
        B21 = B21 * (u_mask[:, :, None] * m_mask[:, None, :]
                     ).astype(B21.dtype)
        return B11.astype(jnp.float32), B21.astype(jnp.float32)

    return blocks


def _resident_scan(spec: WindowKernelSpec, Mp: int, Up: int, tail):
    """Batched-window resident computation: the region's windows run as
    ONE batched pallas Gram per block kind plus a W-batched XLA tail
    (``tail(B11f, B21f, z1, mmk, umk)`` over the full [W] batch).  Very
    long regions fall back to a lax.scan over fixed-size window slabs
    (_win_slabs) to bound the [W, Mp, Mp] HBM temporaries -- the body
    still compiles ONCE, keeping compile time flat in region length
    (the round-4 formulation unrolled 4-window Python loops inside a
    scan body, which compiled superlinearly: 300-670 s cold)."""
    blocks = _resident_block_builder(spec, Mp, Up)

    @jax.jit
    def fn(Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0, Z1, m_mask,
           u_mask):
        W = m_t0.shape[0]
        B = _win_slabs(W)

        def slab(xs):
            mt, ut, z1, mmk, umk = xs
            B11f, B21f = blocks(Xm, Xu, Spm, Spu, Mum, Muu, Vu,
                                mt, ut, mmk, umk)
            return tail(B11f, B21f, z1, mmk, umk)

        xs = (m_t0, u_t0, Z1, m_mask, u_mask)
        if B == W:
            return slab(xs)
        xs = tuple(a.reshape((W // B, B) + a.shape[1:]) for a in xs)
        _, outs = jax.lax.scan(lambda c, x: (c, slab(x)), None, xs)
        return jax.tree_util.tree_map(
            lambda o: o.reshape((W,) + o.shape[2:]), outs)

    return fn


def _blocked_cholesky_lower(A, nb: int = 256):
    """Batched lower Cholesky of A [W, M, M] by the right-looking block
    algorithm: n = M/nb panel steps, each a small [W, nb, nb]
    jnp.linalg.cholesky plus batched matmuls for the Schur updates
    and the below-diagonal panel (multiplied by the explicit inverse of
    the diagonal factor): everything except the n tiny diagonal
    factorizations is an ordinary batched dot.
    Numerics: identical update formula to the standard algorithm; the
    explicit Lii^-1 rounds like a back-substitution scaled by
    cond(Lii), benign for the ridge-regularized B11 (min eig >= 0.1).
    Falls back to jnp.linalg.cholesky when M is not an nb multiple."""
    W, M, _ = A.shape
    nb = min(nb, M)
    if M % nb or M == nb:
        return jnp.linalg.cholesky(A)
    n = M // nb
    eye = jnp.broadcast_to(jnp.eye(nb, dtype=A.dtype), (W, nb, nb))
    cols = []        # cols[k]: [W, M - k*nb, nb] = L[k*nb:, k-th block]
    for i in range(n):
        lo = i * nb
        panel = A[:, lo:, lo:lo + nb]           # [W, M-lo, nb]
        if i:
            Lrows = jnp.concatenate(
                [c[:, lo - k * nb:, :] for k, c in enumerate(cols)],
                axis=2)                          # L[lo:, 0:i*nb]
            Ltop = jnp.concatenate(
                [c[:, lo - k * nb:lo - k * nb + nb, :]
                 for k, c in enumerate(cols)], axis=2)  # L[i-block, 0:i]
            panel = panel - jnp.einsum(
                "wjk,wik->wji", Lrows, Ltop, precision=_HI,
                preferred_element_type=jnp.float32)
        Lii = jnp.linalg.cholesky(panel[:, :nb, :])
        if i + 1 < n:
            LiiInv = jax.scipy.linalg.solve_triangular(Lii, eye,
                                                       lower=True)
            below = jnp.einsum("wjk,wik->wji", panel[:, nb:, :], LiiInv,
                               precision=_HI,
                               preferred_element_type=jnp.float32)
            cols.append(jnp.concatenate([Lii, below], axis=1))
        else:
            cols.append(Lii)
    return jnp.concatenate(
        [jnp.concatenate([jnp.zeros((W, k * nb, nb), A.dtype), c],
                         axis=1) if k else c
         for k, c in enumerate(cols)], axis=2)


def _cholesky(A):
    """Batched lower Cholesky: blocked-matmul algorithm by default
    (GAUSS_BLOCKED_CHOL=0 falls back to jnp.linalg.cholesky)."""
    if os.environ.get("GAUSS_BLOCKED_CHOL", "1") != "0":
        return _blocked_cholesky_lower(A)
    return jnp.linalg.cholesky(A)


def _blocked_trsm_lower(L, B, nb: int = 256):
    """X = L^-1 B for batched lower-triangular L [W, M, M] and
    B [W, M, K], by block forward substitution with explicit
    diagonal-block inverses.

    The off-diagonal updates -- the O(M^2 K) bulk of the flops -- become
    ordinary batched matmuls; only the n = M/nb diagonal-block
    inverses (n*nb^3/2 flops, ~2% of total) still go through
    solve_triangular.  Python loop over n blocks (n <= 6 at production
    shapes) keeps the graph small and static.

    Accuracy: multiplying by an explicitly-inverted diagonal block
    rounds like back-substitution scaled by cond(T_ii); B11's blocks
    inherit min eig >= lambda = 0.1 from the ridge, so the error stays
    at f32 solve scale (bench fused-vs-host max|dZ| unchanged at
    ~1e-5).  Requires M % nb == 0 (region shapes are 256-aligned;
    falls back to one whole-matrix block when M < nb)."""
    W, M, _ = L.shape
    nb = min(nb, M)
    if M % nb:
        return jax.scipy.linalg.solve_triangular(L, B, lower=True)
    n = M // nb
    eye = jnp.eye(nb, dtype=L.dtype)
    Xs = []
    for i in range(n):
        sl = slice(i * nb, (i + 1) * nb)
        acc = B[:, sl, :]
        if i:
            Lrow = L[:, sl, :i * nb]                    # [W, nb, i*nb]
            Xcat = jnp.concatenate(Xs, axis=1)          # [W, i*nb, K]
            acc = acc - jnp.einsum(
                "wij,wjk->wik", Lrow, Xcat, precision=_HI,
                preferred_element_type=jnp.float32)
        Dinv = jax.scipy.linalg.solve_triangular(
            L[:, sl, sl], jnp.broadcast_to(eye, (W, nb, nb)),
            lower=True)
        Xs.append(jnp.einsum("wij,wjk->wik", Dinv, acc, precision=_HI,
                             preferred_element_type=jnp.float32))
    return jnp.concatenate(Xs, axis=1)


def build_resident_region_kernel(spec: WindowKernelSpec, Mp: int,
                                 Up: int):
    """Resident distmix imputation (see _resident_block_builder).

    Returns ONE stacked output so the caller fetches the whole region
    in a single host transfer.  Two call forms:

      fn(..., m_mask, u_mask)           -> [2, W, Up]  (z, info)
      fn(..., m_mask, u_mask, wi, ci)   -> [2, N]      compacted

    The second gathers only the REAL unmeasured rows (wi/ci int32 [N]
    window/column indices, static per region batch), skipping the Up
    padding of the [2, W, Up] fetch."""
    def tail(B11f, B21f, z1, mmk, umk):
        # single-sweep solve: info = colsum((L^-1 B21^T)^2),
        # z2 = (L^-1 B21^T)^T (L^-1 Z1) -- see window_impute
        L = _cholesky(B11f)
        Up_ = B21f.shape[1]
        if os.environ.get("GAUSS_BLOCKED_TRSM", "1") != "0":
            # one blocked-matmul solve for [B21^T | Z1] (the appended
            # Z1 column also removes a latency-bound [., ., 1] trsm)
            rhs = jnp.concatenate(
                [B21f.transpose(0, 2, 1),
                 z1.astype(jnp.float32)[:, :, None]], axis=2)
            Yall = _blocked_trsm_lower(L, rhs)
            Y = Yall[:, :, :Up_]
            y1 = Yall[:, :, Up_]
        else:
            Y = jax.scipy.linalg.solve_triangular(
                L, B21f.transpose(0, 2, 1), lower=True)
            y1 = jax.scipy.linalg.solve_triangular(
                L, z1.astype(jnp.float32)[:, :, None],
                lower=True)[:, :, 0]
        z2 = jnp.einsum("wmu,wm->wu", Y, y1, precision=_HI,
                        preferred_element_type=jnp.float32)
        info = jnp.einsum("wmu,wmu->wu", Y, Y, precision=_HI,
                          preferred_element_type=jnp.float32)
        return (z2 / jnp.sqrt(info), info)

    scan_fn = _resident_scan(spec, Mp, Up, tail)

    @jax.jit
    def fn(*args):
        if len(args) == 14:
            args, (wi, ci) = args[:12], args[12:]
            z, info = scan_fn(*args)
            return jnp.stack([z[wi, ci], info[wi, ci]])
        z, info = scan_fn(*args)     # inner jit inlines: ONE executable
        return jnp.stack([z, info])

    return fn


def build_resident_ld_kernel(spec: WindowKernelSpec, Mp: int,
                             fetch: str = "i16tri",
                             SL: Optional[int] = None):
    """Resident computeLD over a batch of windows in ONE dispatch
    (src/computeLD.cpp:104-116 semantics: weighted correlations of the
    window's measured SNPs, unit diagonal, NO ridge).

    Streams each window's measured band from the bp-sorted resident
    panel (same contiguity argument as the impute kernel; only the mm
    Gram runs -- no unmeasured work).  The output is minimized for
    the host fetch: each window's useful [SL, SL] block (SL = bucketed max
    measured count <= Mp) is sliced out of the band matrix at its row
    offset and packed -- "i16tri" packed int16 lower triangles
    [W, SL(SL+1)/2], "i16full" quantized [W, SL, SL] int16, or "f32"
    [W, SL, SL].  One dispatch + one fetch per region either way.

    Jitted (Xm, Spm, Mum, m_t0 [W], m_loc [W], m_mask [W, Mp]) ->
    output; m_loc is each window's first-row offset inside its band.
    """
    from . import pallas_gram as pg

    pooled = spec.wgts is None
    if pooled:
        raise ValueError("resident LD requires population weights")
    P = len(spec.pop_sizes)
    m = np.asarray(spec.pop_sizes, dtype=np.float64)
    w64 = np.asarray(spec.wgts, dtype=np.float64)
    alpha = jnp.asarray((w64 * m / (m - 1.0)).astype(np.float32))
    w = jnp.asarray(w64, dtype=jnp.float32)
    R = pg.ROW_TILE
    SL = Mp if SL is None else SL

    def slab(Xm, Spm, Mum, m_t0, m_loc, m_mask):
        """Batched over a [W] window slab (see _resident_scan)."""
        t1_mm = pg.weighted_gram_t1(
            Xm, Xm, spec.pop_sizes, spec.pop_sizes_padded, spec.wgts,
            n_sym=Mp // pg.BLOCK, nx=Mp, ny=Mp,
            x_tile0=m_t0, y_tile0=m_t0)                 # [W, Mp, Mp]
        mr = m_t0 * R
        sxm = _slice_rows(Spm, mr, Mp)                  # [W, Mp, P]
        mu_m = _slice_rows(Mum, mr, Mp)
        t2_mm = jnp.einsum("wmp,wnp->wmn", sxm * alpha[None, None, :],
                           sxm, precision=_HI,
                           preferred_element_type=jnp.float32)
        big_mm = pg.mirror_lower(t1_mm) - t2_mm
        mi_m = jnp.dot(mu_m, w, precision=_HI)
        mimj_mm = jnp.einsum("wmp,p,wnp->wmn", mu_m, w, mu_m,
                             precision=_HI)
        cov_mm = (big_mm + mimj_mm) - mi_m[:, :, None] * mi_m[:, None, :]
        var_m = jnp.diagonal(cov_mm, axis1=1, axis2=2)
        std_m = jnp.sqrt(jnp.where(m_mask > 0, var_m, 1.0))
        corr = cov_mm / (std_m[:, :, None] * std_m[:, None, :])
        mm2 = (m_mask[:, :, None] * m_mask[:, None, :]).astype(corr.dtype)
        corr = corr * mm2
        eye = jnp.eye(Mp, dtype=corr.dtype)
        corr = corr * (1.0 - eye) + eye
        # fetch minimization: only the useful [SL, SL] block leaves
        corr = jax.vmap(lambda c, l: jax.lax.dynamic_slice(
            c, (l, l), (SL, SL)))(corr, m_loc)
        if fetch == "i16tri":
            # block-triangle pack (static slices, no batched gather):
            # ~17% more bytes than the exact triangle
            return pack_block_tri_i16(corr)
        if fetch == "i16full":
            return _quant_i16(corr)
        return corr

    @jax.jit
    def fn(Xm, Spm, Mum, m_t0, m_loc, m_mask):
        W = m_t0.shape[0]
        B = _win_slabs(W)
        xs = (m_t0, m_loc, m_mask)
        if B == W:
            return slab(Xm, Spm, Mum, *xs)
        xs = tuple(a.reshape((W // B, B) + a.shape[1:]) for a in xs)
        _, out = jax.lax.scan(
            lambda c, x: (c, slab(Xm, Spm, Mum, *x)), None, xs)
        return out.reshape((W,) + out.shape[2:])

    return fn


def build_resident_qcat_kernel(spec: WindowKernelSpec, Mp: int, Up: int):
    """Resident qcatmix tests (the qcat tail of window_qcat over
    resident-streamed correlation blocks; src/qcatmix.cpp:145-286)."""
    if spec.lam <= spec.eig_cutoff:
        raise ValueError(
            f"device qcat requires lambda ({spec.lam}) > eig_cutoff "
            f"({spec.eig_cutoff}); use the host qcat path")

    def tail(B11f, B21f, z1, mmk, umk):
        n = jnp.sum(mmk, axis=1)                          # = num_eig
        L = _cholesky(B11f)
        Mp_, Up_ = B11f.shape[1], B21f.shape[1]
        if os.environ.get("GAUSS_BLOCKED_TRSM", "1") != "0":
            rhs = jnp.concatenate(
                [B11f, B21f.transpose(0, 2, 1),
                 z1.astype(jnp.float32)[:, :, None]], axis=2)
            Yall = _blocked_trsm_lower(L, rhs)
            Xm = Yall[:, :, :Mp_]
            Xu = Yall[:, :, Mp_:Mp_ + Up_]
            Zt = Yall[:, :, Mp_ + Up_]
        else:
            Zt = jax.scipy.linalg.solve_triangular(
                L, z1.astype(jnp.float32)[:, :, None],
                lower=True)[:, :, 0]
            Xm = jax.scipy.linalg.solve_triangular(L, B11f, lower=True)
            Xu = jax.scipy.linalg.solve_triangular(
                L, B21f.transpose(0, 2, 1), lower=True)
        scale2 = jnp.maximum(n - 3.0, 0.0)
        r_m = _masked_column_corr(Zt, Xm, mmk, n)
        r_u = _masked_column_corr(Zt, Xu, mmk, n)
        return (jnp.sqrt(scale2)[:, None] * r_m,
                scale2[:, None] * r_m * r_m,
                jnp.sqrt(scale2)[:, None] * r_u,
                scale2[:, None] * r_u * r_u,
                n)

    return _resident_scan(spec, Mp, Up, tail)


@partial(jax.jit, static_argnames=("spec", "n_rows"))
def prepare_resident_panel(G_dev, rows, n_rows: Optional[int],
                           spec: WindowKernelSpec):
    """One-time transform for the resident region kernel: gather the
    bp-sorted row subset (a one-time cost), zero the padding rows, and
    precompute shifted dosages + per-row statistics.

    rows: [RN] int32 panel row ids; entries at positions >= n_rows are
    padding -- or, with n_rows=None, NEGATIVE entries are padding
    (sentinel form, used by the per-window aligned layout where pad
    rows interleave between window bands).
    Returns (X_shifted [RN, S] int8, Sp [RN, P] f32, Mu [RN, P] f32,
    V [RN] f32) with the exact int32 arithmetic of
    _pallas_weighted_stats (shifts c = round(mean) in {0,1,2}).

    Pooled mode (spec.wgts is None): a single subject group -- Sp/Mu
    come back [RN, 1] (pooled shifted sum / mean) and V is the pooled
    centered sum of squares sum_s (x - xbar)^2 = Q' - S'^2/n; every
    integer intermediate stays < 8n, exact in int32."""
    bounds = spec.bounds
    P = len(spec.pop_sizes)
    S = int(bounds[-1])

    pop_idx = np.zeros(S, dtype=np.int32)
    valid = np.zeros(S, dtype=np.int8)
    onehot = np.zeros((S, P), dtype=np.int8)
    for k in range(P):
        lo = int(bounds[k])
        pop_idx[lo:lo + int(spec.pop_sizes_padded[k])] = k
        valid[lo:lo + int(spec.pop_sizes[k])] = 1
        onehot[lo:lo + int(spec.pop_sizes[k]), k] = 1
    valid_d = jnp.asarray(valid)

    if n_rows is None:
        real = (rows >= 0).astype(jnp.int8)
        rows = jnp.maximum(rows, 0)
    else:
        real = (jnp.arange(rows.shape[0]) < n_rows).astype(jnp.int8)
    X = jnp.take(G_dev, rows, axis=0)
    X = X * real[:, None]
    dn = (((1,), (0,)), ((), ()))

    if spec.wgts is None:
        n_i = int(sum(spec.pop_sizes))
        nf = float(n_i)
        vcol = jnp.asarray(valid.reshape(S, 1))
        Ssum = jax.lax.dot_general(X, vcol, dn,
                                   preferred_element_type=jnp.int32)
        Q = jax.lax.dot_general(X * X, vcol, dn,
                                preferred_element_type=jnp.int32)
        c = jnp.clip(jnp.round(Ssum.astype(jnp.float32) / nf), 0, 2
                     ).astype(jnp.int32)                     # [RN, 1]
        Spi = Ssum - n_i * c
        Sp = Spi.astype(jnp.float32)
        X_shift = (X - c.astype(jnp.int8)) * valid_d[None, :] \
            * real[:, None]
        Mu = Ssum.astype(jnp.float32) / nf
        # shifted Q' = Q - 2c*S + n*c^2 (exact); V = Q' - S'^2/n
        Qp = Q - 2 * c * Ssum + (n_i * c) * c
        V = (Qp.astype(jnp.float32)
             - Sp * (Sp * (1.0 / nf)))[:, 0]
        return X_shift, Sp, Mu, V

    m_i32 = jnp.asarray(np.asarray(spec.pop_sizes, np.int32))
    mf = jnp.asarray(np.asarray(spec.pop_sizes, np.float32))
    m64 = np.asarray(spec.pop_sizes, dtype=np.float64)
    w64 = np.asarray(spec.wgts, dtype=np.float64)
    alpha = jnp.asarray((w64 * m64 / (m64 - 1.0)).astype(np.float32))
    onehot_d = jnp.asarray(onehot)
    pop_idx_d = jnp.asarray(pop_idx)
    Ssum = jax.lax.dot_general(X, onehot_d, dn,
                               preferred_element_type=jnp.int32)
    Q = jax.lax.dot_general(X * X, onehot_d, dn,
                            preferred_element_type=jnp.int32)
    c = jnp.clip(jnp.round(Ssum.astype(jnp.float32) / mf), 0, 2
                 ).astype(jnp.int32)
    Sp = (Ssum - m_i32 * c).astype(jnp.float32)
    cs = jnp.take(c.astype(jnp.int8), pop_idx_d, axis=1)
    X_shift = (X - cs) * valid_d[None, :] * real[:, None]
    Mu = Ssum.astype(jnp.float32) / mf
    d = m_i32 * Q - Ssum * Ssum                      # exact int32
    V = jnp.dot(d.astype(jnp.float32), alpha, precision=_HI)
    return X_shift, Sp, Mu, V


def build_gather_window_kernel(spec: WindowKernelSpec):
    """Device-resident variant: the decoded panel stays in HBM and each
    window is materialized by an on-device row gather, so only index
    vectors cross the host link per window.

    Returns jitted (G_dev [R, S] int8, m_idx [W, Mp] i32, u_idx [W, Up]
    i32, Z1, m_mask, u_mask) -> (z, info).  Padded index entries may be
    any valid row (use 0): gathered garbage rows are fully neutralized
    by the masks inside window_impute.

    The gather is jitted separately from the impute kernel: fusing a
    row gather over the whole panel into the window program makes XLA's
    fusion search pathologically slow (~6x compile time observed).
    """
    gather = jax.jit(partial(jnp.take, axis=0))
    impute = jax.jit(partial(window_impute, spec=spec))

    def fn(G_dev, m_idx, u_idx, Z1, m_mask, u_mask):
        Gm = gather(G_dev, m_idx)
        Gu = gather(G_dev, u_idx)
        return impute(Gm, Gu, Z1, m_mask, u_mask)

    return fn
