"""Fused weighted-Gram kernel (Pallas, Triton route) vs float64 oracle.

The kernel runs in the Pallas interpreter here; the XLA form runs as
compiled on the CPU.  ``gpu``-marked tests compile the kernel for the
card and skip elsewhere.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gauss_jax.ops import pallas_gram as pg
from gauss_jax.ops.pallas_gram import (BLOCK, K_TILE, ROW_TILE, mirror_lower,
                                       weighted_gram_reference,
                                       weighted_gram_t1)
from gauss_jax.ops.window_kernel import (WindowKernelSpec,
                                         _int8_weighted_stats,
                                         _pallas_weighted_stats)


def _pad(sizes):
    return [-(-s // K_TILE) * K_TILE for s in sizes]


def _panel(rng, n_rows, sizes, padded, lo=0, hi=3):
    S = sum(padded)
    G = np.zeros((n_rows, S), np.int8)
    bounds = np.concatenate([[0], np.cumsum(padded)])
    for k, s in enumerate(sizes):
        b = int(bounds[k])
        G[:, b:b + s] = rng.integers(lo, hi, (n_rows, s))
    return G


def _gram(impl, *args, **kw):
    if impl == "kernel":
        return weighted_gram_t1(*args, interpret=True, **kw)
    kw.pop("n_sym", None)
    return pg.weighted_gram_t1_xla(*args, **kw)


#: sizes, row counts, symmetric skip, band offsets; "pooled" is the
#: homogeneous dist mode (one segment over the padded axis, beta == 1)
CASES = {
    "plain": dict(sizes=[100, 300, 55, 220], nx=2 * BLOCK, ny=BLOCK),
    "sym": dict(sizes=[90, 150], nx=2 * BLOCK, ny=2 * BLOCK, sym=True),
    "ragged": dict(sizes=[K_TILE, 2, K_TILE + 1, 3], nx=BLOCK, ny=BLOCK),
    "band": dict(sizes=[70, 200], nx=ROW_TILE, ny=ROW_TILE, sym=True,
                 bands=([0, 2, 1], [0, 2, 1])),
    "band_cross": dict(sizes=[70, 200, 33], nx=2 * BLOCK, ny=ROW_TILE,
                       bands=([1, 0], [2, 1])),
    "pooled": dict(sizes=[300], nx=ROW_TILE, ny=ROW_TILE, sym=True,
                   pooled=True, bands=([0, 1], [0, 1])),
}


@pytest.mark.parametrize("impl", ["kernel", "xla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_weighted_gram_t1_matches_oracle(case, impl):
    c = CASES[case]
    rng = np.random.default_rng(3)
    sizes = c["sizes"]
    padded = _pad(sizes)
    if c.get("pooled"):
        n = float(sizes[0])
        padded = [sum(padded) + K_TILE]
        w = [(n - 1.0) / (n * n)]
    else:
        w = rng.dirichlet(np.ones(len(sizes)))
    bands = c.get("bands")
    nx, ny = c["nx"], c["ny"]
    n_rows = 4 * ROW_TILE if bands else nx
    X = _panel(rng, n_rows, sizes, padded, lo=-2)
    Y = X if c.get("sym") else _panel(rng, n_rows if bands else ny,
                                      sizes, padded, lo=-2)
    n_sym = nx // BLOCK if c.get("sym") else 0
    kw = dict(n_sym=n_sym)
    if bands:
        kw.update(nx=nx, ny=ny, x_tile0=np.asarray(bands[0], np.int32),
                  y_tile0=np.asarray(bands[1], np.int32))
    out = np.asarray(_gram(impl, jnp.asarray(X), jnp.asarray(Y), sizes,
                           padded, w, **kw))
    if c.get("sym"):
        out = np.asarray(mirror_lower(jnp.asarray(out)))
    offs = zip(*bands) if bands else [(0, 0)]
    outs = out if bands else out[None]
    for (xo, yo), got in zip(offs, outs):
        xs = X[xo * ROW_TILE:xo * ROW_TILE + nx]
        ys = Y[yo * ROW_TILE:yo * ROW_TILE + ny]
        ref = weighted_gram_reference(xs, ys, sizes if not c.get("pooled")
                                      else [int(sizes[0])], padded, w)
        assert got.shape == ref.shape
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel < 1e-6, rel


def test_weighted_gram_t1_triangle_mirror():
    rng = np.random.default_rng(4)
    sizes = [90, 150]
    padded = _pad(sizes)
    w = [0.4, 0.6]
    X = _panel(rng, 2 * BLOCK, sizes, padded)
    full = np.asarray(weighted_gram_t1(
        jnp.asarray(X), jnp.asarray(X), sizes, padded, w, interpret=True))
    tri = np.asarray(mirror_lower(jnp.asarray(weighted_gram_t1(
        jnp.asarray(X), jnp.asarray(X), sizes, padded, w,
        n_sym=X.shape[0] // BLOCK, interpret=True))))
    np.testing.assert_allclose(tri, full, rtol=1e-6, atol=1e-3)


def test_weighted_gram_t1_backend_choice(monkeypatch):
    """CPU takes the XLA form; a GPU backend takes the kernel, with one
    program per (tile pair, window) and K_TILE-block segment bounds."""
    rng = np.random.default_rng(6)
    sizes = [100, 300]
    padded = _pad(sizes)
    X = jnp.asarray(_panel(rng, 2 * ROW_TILE, sizes, padded))
    t0 = np.asarray([0, 1], np.int32)
    args = (X, X, sizes, padded, [0.5, 0.5])
    kw = dict(n_sym=ROW_TILE // BLOCK, nx=ROW_TILE, ny=ROW_TILE,
              x_tile0=t0, y_tile0=t0)

    def no_kernel(*a, **k):
        raise AssertionError("pallas_call on the CPU")

    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    monkeypatch.setattr(pg.pl, "pallas_call", no_kernel)
    cpu = np.asarray(weighted_gram_t1(*args, **kw))
    np.testing.assert_array_equal(
        cpu, np.asarray(pg.weighted_gram_t1_xla(*args, **{
            k: v for k, v in kw.items() if k != "n_sym"})))

    seen = {}

    def fake_call(kernel, out_shape, grid, backend, **k):
        seen.update(out_shape=out_shape.shape, grid=grid, backend=backend)

        def run(seg, beta, pi, pj, xr, yr, x, y):
            seen.update(seg=np.asarray(seg), pairs=len(pi),
                        rows=(np.asarray(xr), np.asarray(yr)))
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return run

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(pg.pl, "pallas_call", fake_call)
    out = weighted_gram_t1(*args, **kw)
    n_t = ROW_TILE // BLOCK
    assert out.shape == (2, ROW_TILE, ROW_TILE)
    assert seen["backend"] == "triton"
    assert seen["pairs"] == n_t * (n_t + 1) // 2       # lower triangle
    assert seen["grid"] == (seen["pairs"], 2)
    np.testing.assert_array_equal(seen["seg"], [0, 1, 4])
    np.testing.assert_array_equal(seen["rows"][0], [0, ROW_TILE])


def test_weighted_gram_t1_rejects_bad_layout():
    X = jnp.zeros((BLOCK, 100), jnp.int8)
    with pytest.raises(ValueError, match="multiple"):
        weighted_gram_t1(X, X, [100], [100], [1.0], interpret=True)
    X = jnp.zeros((BLOCK + 8, K_TILE), jnp.int8)
    with pytest.raises(ValueError, match="multiples"):
        weighted_gram_t1(X, X, [100], [K_TILE], [1.0], interpret=True)


@pytest.mark.parametrize("rows,S,padded", [
    (1000, 1024, False),                  # < 2 GiB: 32-bit offsets work
    (2**31 // 1024, 1024, True),          # 2 GiB: would wrap
    (2**32 // 1024, 1024, True),          # 4 GiB: still 32-bit
    (2**32 // 1024 + 1, 1024, False),     # > 4 GiB: 64-bit offsets
])
def test_offsets_fit_pads_wrapping_sizes(rows, S, padded):
    out = jax.eval_shape(pg._offsets_fit,
                         jax.ShapeDtypeStruct((rows, S), jnp.int8))
    assert (out.shape[0] != rows) == padded
    assert out.shape[1] == S
    if padded:
        assert out.shape[0] * S > 2**32


@pytest.mark.parametrize("K", [1, 2, 3, 5, 17, 33, 64])
def test_int_gram_exact_at_any_contraction_length(K):
    """_int_gram zero-pads K to a multiple of 4 (the GPU's s8 GEMM was
    wrong otherwise) and stays exact, batched and rank-2 alike."""
    from gauss_jax.ops.window_kernel import _int_gram
    rng = np.random.default_rng(K)
    a = rng.integers(-2, 3, (2, 16, K), np.int8)
    b = rng.integers(-2, 3, (2, 5, K), np.int8)
    got = np.asarray(_int_gram(jnp.asarray(a), jnp.asarray(b),
                               (((2,), (2,)), ((0,), (0,)))))
    assert got.dtype == np.int32 and got.shape == (2, 16, 5)
    np.testing.assert_array_equal(
        got, np.einsum("wik,wjk->wij", a.astype(np.int64),
                       b.astype(np.int64)))
    oh = np.eye(K, 3, dtype=np.int8)
    got = np.asarray(_int_gram(jnp.asarray(a), jnp.asarray(oh),
                               (((2,), (0,)), ((), ()))))
    np.testing.assert_array_equal(got, a.astype(np.int64) @ oh)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_pallas_stats_matches_int8_stats(monkeypatch, impl):
    """The full shifted-stat pipeline agrees with the exact int8 path."""
    if impl == "kernel":
        monkeypatch.setattr(pg, "weighted_gram_t1", functools.partial(
            weighted_gram_t1, interpret=True))
    rng = np.random.default_rng(5)
    sizes = (100, 700, 55, 220)
    padded = tuple(_pad(sizes))
    S = sum(padded)
    Mp = Up = ROW_TILE
    bounds = np.concatenate([[0], np.cumsum(padded)])

    def mk(n):
        G = np.zeros((2, n, S), np.int8)
        for k, s in enumerate(sizes):
            lo = int(bounds[k])
            G[:, :, lo:lo + s] = rng.integers(0, 3, (2, n, s))
        return jnp.asarray(G)

    Gm, Gu = mk(Mp), mk(Up)
    w = tuple(rng.dirichlet(np.ones(len(sizes))).tolist())
    spec = WindowKernelSpec(pop_sizes=sizes, pop_sizes_padded=padded, wgts=w)
    a = _int8_weighted_stats(Gm, Gu, spec)
    b = _pallas_weighted_stats(Gm, Gu, spec)
    for name, x, y in zip(["big_mm", "big_um", "vu", "S_m", "S_u"], a, b):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        scale = max(np.abs(x).max(), 1.0)
        assert np.abs(x - y).max() / scale < 1e-6, name


@pytest.mark.gpu
def test_weighted_gram_t1_compiled_on_gpu(gpu):
    """The kernel as compiled for the card, 29 populations, band mode
    with the symmetric skip, against the float64 oracle."""
    rng = np.random.default_rng(7)
    sizes = [int(s) for s in rng.integers(60, 600, 29)]
    padded = _pad(sizes)
    w = rng.dirichlet(np.ones(len(sizes)))
    X = _panel(rng, 3 * ROW_TILE, sizes, padded, lo=-2)
    t0 = np.asarray([0, 1], np.int32)
    out = np.asarray(mirror_lower(weighted_gram_t1(
        jnp.asarray(X), jnp.asarray(X), sizes, padded, w,
        n_sym=2 * ROW_TILE // BLOCK, nx=2 * ROW_TILE, ny=2 * ROW_TILE,
        x_tile0=t0, y_tile0=t0)))
    for i, o in enumerate(t0):
        xs = X[o * ROW_TILE:(o + 2) * ROW_TILE]
        ref = weighted_gram_reference(xs, xs, sizes, padded, w)
        assert np.abs(out[i] - ref).max() / np.abs(ref).max() < 1e-6
