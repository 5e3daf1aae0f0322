"""Fused per-population weighted Gram matrix (Pallas, Triton route).

The hot operation of every *mix analysis (distmix/computeLD/qcatmix/
jepegmix) is the dominant term of the reference's weighted covariance
(CalWgtCov, reference src/util.cpp:103-124) over a window's dosage rows:

    BIG[i, j] = sum_k alpha_k * (m_k * (X_k Y_k^T)[i,j] - Sx_k[i] Sy_k[j])
    alpha_k   = w_k * m_k / (m_k - 1)

where X_k/Y_k are the population-k subject columns and Sx/Sy per-pop
row sums.  ``weighted_gram_t1`` evaluates the heavy first term

    T1[i, j] = sum_k beta_k * (X_k Y_k^T)[i, j],   beta_k = alpha_k m_k

in one of two forms with one contract:

* the GPU kernel: each program owns one BLOCK x BLOCK output tile of
  one window and walks the subject axis population segment by segment;
  the int8 products accumulate EXACTLY in an int32 register tile
  (|dosage - shift| <= 2 and m_k <= 2^13 keep m_k*C < 2^31), which
  folds into an f32 tile scaled by beta_k at each segment end.  Only
  the f32 tile reaches device memory;
* the XLA form (``weighted_gram_t1_xla``): one int8 -> int32
  ``dot_general`` per population, weighted and summed.  It writes and
  re-reads every population's int32 Gram, and is what the CPU runs.

B11 is symmetric, so the kernel's program list skips the tiles strictly
above the diagonal of the leading ``n_sym`` block (~25% of a window's
products); callers mirror them with ``mirror_lower``.  Population
segments are zero-padded to ``K_TILE`` subject columns; padded columns
contribute exactly 0.

The rank-P correction sum_k alpha_k Sx_k Sy_k^T is a tiny [N, P] x
[P, N] f32 matmul the caller evaluates in XLA.  To keep the T1 - T2
subtraction result-scale (no catastrophic cancellation on
low-variance SNPs), callers FIRST shift each dosage row by the
per-(row, population) integer c = round(mean dosage) in {0, 1, 2}:
covariance is invariant under per-row shifts, the shifted identity
m*C' - S'S'^T = m*C - SS^T holds exactly in integers, and both T1'
and T2' shrink to O(result), so f32 rounding stays ~1e-7 of the
result everywhere (ops/window_kernel._pallas_weighted_stats).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

#: Row alignment of resident bands and padded window shapes; band
#: offsets (``x_tile0``/``y_tile0``) count in these units.
ROW_TILE = 256
#: Output tile edge of one kernel program (a power of two dividing
#: ROW_TILE).
BLOCK = 128
#: Subject-axis block of the kernel's inner loop; population segments
#: are zero-padded to a multiple of it.
K_TILE = 128
# BLOCK 128 with 4 warps and 3 pipeline stages was the fastest of six
# configurations timed on an H100 at the 43-window bench shapes (PERF.md)
_NUM_WARPS = 4
_NUM_STAGES = 3


def use_kernel() -> bool:
    """The GPU runs the Pallas kernel; every other backend the XLA
    form."""
    return jax.default_backend() == "gpu"


def segment_tables(pop_sizes_padded: Sequence[int], pop_sizes: Sequence[int],
                   wgts: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
    """(segment bounds in K_TILE blocks [P+1] int32, beta_k [P] f32)."""
    for k, sp in enumerate(pop_sizes_padded):
        if sp % K_TILE:
            raise ValueError(
                f"population segment {k} width {sp} not a multiple of "
                f"{K_TILE}; pad the panel with pad_pop_segments")
    m = np.asarray(pop_sizes, dtype=np.float64)
    w = np.asarray(wgts, dtype=np.float64)
    beta = (w * m * m / (m - 1.0)).astype(np.float32)   # alpha_k * m_k
    blocks = np.asarray(pop_sizes_padded, dtype=np.int64) // K_TILE
    bounds = np.concatenate([[0], np.cumsum(blocks)]).astype(np.int32)
    return bounds, beta


def pair_tables(n_sym: int, n_rows: int, n_cols: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Row/col BLOCK-tile pair lists: the first ``n_sym`` row tiles form
    a symmetric block with the cols (tiles strictly above the diagonal
    are skipped); the remaining row tiles pair with every col tile."""
    pi, pj = [], []
    for i in range(n_rows):
        for j in range(n_cols):
            if i < n_sym and j > i:
                continue
            pi.append(i)
            pj.append(j)
    return np.asarray(pi, np.int32), np.asarray(pj, np.int32)


def _gram_kernel(seg_ref, beta_ref, pi_ref, pj_ref, xr_ref, yr_ref,
                 x_ref, y_ref, o_ref, *, n_seg: int):
    g = pl.program_id(0)
    w = pl.program_id(1)
    i = pi_ref[g]
    j = pj_ref[g]
    x0 = xr_ref[w] + i * BLOCK
    y0 = yr_ref[w] + j * BLOCK

    def segment(p, acc):
        def step(k, c):
            ks = pl.multiple_of(k * K_TILE, K_TILE)
            a = x_ref[pl.ds(x0, BLOCK), pl.ds(ks, K_TILE)]
            b = y_ref[pl.ds(y0, BLOCK), pl.ds(ks, K_TILE)]
            return c + jax.lax.dot_general(
                a, b, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32)

        c = jax.lax.fori_loop(seg_ref[p], seg_ref[p + 1], step,
                              jnp.zeros((BLOCK, BLOCK), jnp.int32))
        return acc + beta_ref[p] * c.astype(jnp.float32)

    acc = jax.lax.fori_loop(0, n_seg, segment,
                            jnp.zeros((BLOCK, BLOCK), jnp.float32))
    o_ref[w, pl.ds(i * BLOCK, BLOCK), pl.ds(j * BLOCK, BLOCK)] = acc


def _offsets_fit(A):
    """The Triton route indexes arrays of at most 4 GiB with 32-bit
    offsets, which wrap above 2 GiB: pad such arrays past 4 GiB so that
    they take 64-bit offsets."""
    R, S = A.shape
    if 2**31 <= A.size <= 2**32:
        A = jnp.pad(A, ((0, 2**32 // S + 1 - R), (0, 0)))
    return A


def _band_rows(tile0):
    """Per-window first rows ([W] int32) of ROW_TILE-unit offsets."""
    if tile0 is None:
        return jnp.zeros(1, jnp.int32)
    return jnp.asarray(tile0, jnp.int32).reshape(-1) * ROW_TILE


def weighted_gram_t1(X: jnp.ndarray, Y: jnp.ndarray,
                     pop_sizes: Sequence[int],
                     pop_sizes_padded: Sequence[int],
                     wgts: Sequence[float],
                     n_sym: int = 0,
                     interpret: bool = False,
                     nx: int = 0, ny: int = 0,
                     x_tile0=None, y_tile0=None) -> jnp.ndarray:
    """T1[NX, NY] f32 = sum_k (alpha_k m_k) * X_k Y_k^T.

    X: [NX, S] int8, Y: [NY, S] int8, with S = sum(pop_sizes_padded),
    every population segment zero-padded to a K_TILE multiple and
    NX/NY BLOCK multiples.  If ``n_sym`` > 0, the leading n_sym*BLOCK
    rows of X are assumed identical to Y's leading rows and the tiles
    above that block's diagonal may be left uninitialized (mirror with
    ``mirror_lower``).

    Band mode: pass ``x_tile0``/``y_tile0`` (int32 [W] vectors, in
    ROW_TILE units) and output sizes ``nx``/``ny`` to compute, for each
    window w, the Gram of the row bands X[x_tile0[w]*ROW_TILE :][:nx]
    and Y[y_tile0[w]*ROW_TILE :][:ny] of much larger resident arrays;
    the output is then [W, nx, ny].  Windows are contiguous row ranges
    of the bp-sorted panels, so no window is ever gathered.

    The GPU runs the Pallas kernel, other backends the XLA form;
    ``interpret`` runs the kernel in the Pallas interpreter (tests)."""
    if not (interpret or use_kernel()):
        return weighted_gram_t1_xla(X, Y, pop_sizes, pop_sizes_padded,
                                    wgts, nx=nx, ny=ny, x_tile0=x_tile0,
                                    y_tile0=y_tile0)
    batched = x_tile0 is not None
    if batched and (not nx or not ny):
        raise ValueError("band mode needs explicit nx/ny")
    if not batched:
        nx, ny = X.shape[0], Y.shape[0]
    if X.shape[1] != Y.shape[1] or X.shape[1] != sum(pop_sizes_padded):
        raise ValueError("pop_sizes_padded does not match subject axis")
    if nx % BLOCK or ny % BLOCK:
        raise ValueError(f"row counts ({nx}, {ny}) must be multiples of "
                         f"{BLOCK}")
    seg, beta = segment_tables(pop_sizes_padded, pop_sizes, wgts)
    pi, pj = pair_tables(n_sym, nx // BLOCK, ny // BLOCK)
    x_r0 = _band_rows(x_tile0)
    y_r0 = _band_rows(y_tile0)
    W = int(x_r0.shape[0])
    S = X.shape[1]
    kernel = lambda *refs: _gram_kernel(*refs, n_seg=len(beta))
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((W, nx, ny), jnp.float32),
        grid=(len(pi), W),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=_NUM_STAGES),
        cost_estimate=pl.CostEstimate(
            flops=2 * W * len(pi) * BLOCK * BLOCK * S,
            bytes_accessed=W * len(pi) * 2 * BLOCK * S + 4 * W * nx * ny,
            transcendentals=0),
        interpret=interpret,
        name="weighted_gram_t1",
    )(jnp.asarray(seg), jnp.asarray(beta), jnp.asarray(pi), jnp.asarray(pj),
      x_r0, y_r0, _offsets_fit(X), _offsets_fit(Y))
    return out if batched else out[0]


def weighted_gram_t1_xla(X, Y, pop_sizes, pop_sizes_padded, wgts,
                         nx: int = 0, ny: int = 0,
                         x_tile0=None, y_tile0=None) -> jnp.ndarray:
    """XLA form of ``weighted_gram_t1`` (same contract; the symmetric
    block is computed in full): per population one exact int8 -> int32
    dot_general, scaled by beta_k and summed in f32."""
    batched = x_tile0 is not None
    if batched:
        X = jax.vmap(lambda r: jax.lax.dynamic_slice_in_dim(X, r, nx))(
            _band_rows(x_tile0))
        Y = jax.vmap(lambda r: jax.lax.dynamic_slice_in_dim(Y, r, ny))(
            _band_rows(y_tile0))
        dn = (((2,), (2,)), ((0,), (0,)))
    else:
        dn = (((1,), (1,)), ((), ()))
    seg, beta = segment_tables(pop_sizes_padded, pop_sizes, wgts)
    if X.shape[-1] != int(seg[-1]) * K_TILE:
        raise ValueError("pop_sizes_padded does not match subject axis")
    acc = jnp.zeros(X.shape[:-1] + Y.shape[-2:-1], jnp.float32)
    for k in range(len(beta)):
        lo, hi = int(seg[k]) * K_TILE, int(seg[k + 1]) * K_TILE
        c = jax.lax.dot_general(X[..., lo:hi], Y[..., lo:hi], dn,
                                preferred_element_type=jnp.int32)
        acc = acc + beta[k] * c.astype(jnp.float32)
    return acc


def mirror_lower(A: jnp.ndarray) -> jnp.ndarray:
    """Symmetrize a matrix whose strict upper triangle is garbage
    (batched over any leading dims)."""
    lo = jnp.tril(A)
    return lo + jnp.swapaxes(jnp.tril(A, -1), -1, -2)


def weighted_gram_reference(X, Y, pop_sizes, pop_sizes_padded, wgts):
    """Numpy float64 oracle of T1 = sum_k beta_k X_k Y_k^T (tests and
    the chip smoke)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    m = np.asarray(pop_sizes, dtype=np.float64)
    w = np.asarray(wgts, dtype=np.float64)
    bounds = np.concatenate([[0], np.cumsum(pop_sizes_padded)])
    out = np.zeros((X.shape[0], Y.shape[0]))
    for k in range(len(pop_sizes)):
        a = X[:, int(bounds[k]):int(bounds[k + 1])]
        b = Y[:, int(bounds[k]):int(bounds[k + 1])]
        out += (w[k] * m[k] * m[k] / (m[k] - 1.0)) * (a @ b.T)
    return out
