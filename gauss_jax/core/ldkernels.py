"""Windowed LD kernels: the device compute for every GAUSS analysis.

These functions take int8 dosage blocks and produce float64 correlation
structures, combining the exact f32 sufficient statistics
(core/stats.py) with f64 combines.  They are the device replacement
for the reference's O(N^2 * subjects) scalar loops
(reference: src/distmix.cpp:188-236, src/computeLD.cpp:104-116,
src/dist.cpp:171-210).

Population sizes and weights are passed as static tuples: they are baked
into the compiled kernel as constants, which both avoids host->device
traffic for tiny vectors and keeps the f64 combine bitwise deterministic.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import stats


def _key(v) -> Tuple[float, ...]:
    return tuple(float(x) for x in v)


@partial(jax.jit, static_argnames=("pop_sizes", "wgts"))
def _wgt_cov_block(Ga, Gb, pop_sizes, wgts):
    bounds = stats.segment_bounds(pop_sizes)
    C = stats.pop_cross_products(Ga, Gb, bounds)
    Sa, _ = stats.pop_row_stats(Ga, bounds)
    Sb, _ = stats.pop_row_stats(Gb, bounds)
    return stats.wgt_cov_combine(C, Sa, Sb,
                                 np.asarray(pop_sizes), np.asarray(wgts))


@partial(jax.jit, static_argnames=("pop_sizes", "wgts"))
def _wgt_var_block(G, pop_sizes, wgts):
    bounds = stats.segment_bounds(pop_sizes)
    S, Q = stats.pop_row_stats(G, bounds)
    return stats.wgt_var_combine(Q, S, np.asarray(pop_sizes), np.asarray(wgts))


def weighted_std(G: np.ndarray, pop_sizes, wgts) -> np.ndarray:
    """Per-SNP weighted standard deviations, SNP_STD_VEC in the reference
    (src/distmix.cpp:179-187): sqrt(CalWgtCov(x, x))."""
    var = _wgt_var_block(jnp.asarray(G), _key(pop_sizes), _key(wgts))
    return np.sqrt(np.asarray(var))


def weighted_corr(Ga: np.ndarray, Gb: np.ndarray, pop_sizes, wgts,
                  std_a: Optional[np.ndarray] = None,
                  std_b: Optional[np.ndarray] = None) -> np.ndarray:
    """Weighted correlation block: CalWgtCov(i,j) / (std_i std_j)
    (reference: src/distmix.cpp:188-200)."""
    cov = np.asarray(_wgt_cov_block(jnp.asarray(Ga), jnp.asarray(Gb),
                                    _key(pop_sizes), _key(wgts)))
    if std_a is None:
        std_a = weighted_std(Ga, pop_sizes, wgts)
    if std_b is None:
        std_b = weighted_std(Gb, pop_sizes, wgts)
    # A zero-variance (monomorphic-in-every-pop) SNP divides 0/0 here,
    # exactly like the reference's CalWgtCov-based correlation
    # (src/distmix.cpp:188-200 divides by SNP_STD_VEC entries that can
    # be 0): the NaN PROPAGATES to that SNP's row/column by design --
    # asserted in tests/test_edge_parity.py, documented in README
    # deviations.  errstate only silences the incidental warning.
    with np.errstate(divide="ignore", invalid="ignore"):
        return cov / np.outer(std_a, std_b)


@jax.jit
def _pooled_corr_block(Ga, Gb):
    return stats.pooled_corr_matrix(Ga, Gb)


def pooled_corr(Ga: np.ndarray, Gb: np.ndarray) -> np.ndarray:
    """Unweighted pooled correlation block (reference CalCor over
    concatenated population strings, src/util.cpp:49-70)."""
    return np.asarray(_pooled_corr_block(jnp.asarray(Ga), jnp.asarray(Gb)))


def per_pop_corr(G: np.ndarray, pop_sizes) -> np.ndarray:
    """Per-population correlation matrices [P, N, N] (reference:
    per-string CalCor, src/util.cpp:153-169)."""
    fn = jax.jit(stats.per_pop_corr_matrices, static_argnames=())
    bounds = stats.segment_bounds(pop_sizes)
    return np.asarray(stats.per_pop_corr_matrices(jnp.asarray(G), bounds))


def set_diag(a: np.ndarray, value: float) -> np.ndarray:
    """Overwrite the diagonal (the reference writes diagonals explicitly:
    1.0 for computeLD, 1+lambda for B11)."""
    out = a.copy()
    np.fill_diagonal(out, value)
    return out
