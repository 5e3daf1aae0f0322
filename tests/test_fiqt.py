"""fiqt winner's-curse correction tests."""

import numpy as np
import pytest
from scipy import stats as st

import gauss_jax
from gauss_jax.utils.special import bh_adjust


def test_bh_matches_scipy():
    rng = np.random.default_rng(0)
    p = rng.uniform(size=200)
    ours = bh_adjust(p)
    ref = st.false_discovery_control(p, method="bh")
    np.testing.assert_allclose(ours, ref, rtol=1e-12)


def test_fiqt_literal_formula():
    rng = np.random.default_rng(1)
    z = np.concatenate([rng.standard_normal(500) * 2, [45.0, -45.0]])
    out = gauss_jax.fiqt(z)
    # literal R translation
    pv = np.maximum(2 * st.norm.sf(np.abs(z)), 1e-300)
    adj = st.false_discovery_control(pv, method="bh")
    mu = np.sign(z) * st.norm.isf(adj / 2)
    extreme = np.abs(z) > st.norm.isf(1e-300 / 2)
    expect = np.where(extreme, z, mu)
    np.testing.assert_allclose(out, expect, rtol=1e-10, atol=1e-12)


def test_fiqt_shrinks_and_preserves_sign():
    rng = np.random.default_rng(2)
    z = rng.standard_normal(300) * 3
    out = gauss_jax.fiqt(z)
    assert (np.abs(out) <= np.abs(z) + 1e-12).all()
    nz = z != 0
    assert (np.sign(out[nz]) == np.sign(z[nz])).all() or \
        (out[nz][np.sign(out[nz]) != np.sign(z[nz])] == 0).all()


def test_fiqt_extreme_passthrough():
    z = np.array([40.0, -40.0, 1.0])
    out = gauss_jax.fiqt(z)
    assert out[0] == 40.0 and out[1] == -40.0
    # the small-z entry has max BH rank: adj == p, so z is unchanged
    assert out[2] == pytest.approx(1.0, rel=1e-12)
