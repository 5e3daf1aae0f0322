"""LD kernel correctness vs scalar float64 oracles."""

import numpy as np
import pytest

from gauss_jax.core import ldkernels

import oracle


@pytest.fixture(scope="module")
def geno():
    rng = np.random.default_rng(42)
    pop_sizes = (23, 41, 17)
    G = rng.integers(0, 3, size=(30, sum(pop_sizes))).astype(np.int8)
    wgts = (0.5, 0.2, 0.3)
    return G, pop_sizes, wgts


def test_weighted_std_matches_oracle(geno):
    G, pop_sizes, wgts = geno
    std = ldkernels.weighted_std(G, pop_sizes, wgts)
    expect = np.array([np.sqrt(oracle.cal_wgt_cov(G[i], G[i], pop_sizes, wgts))
                       for i in range(G.shape[0])])
    np.testing.assert_allclose(std, expect, rtol=1e-14, atol=0)


def test_weighted_corr_matches_oracle(geno):
    G, pop_sizes, wgts = geno
    got = ldkernels.weighted_corr(G[:12], G[12:], pop_sizes, wgts)
    expect = oracle.weighted_corr_matrix(G[:12], G[12:], pop_sizes, wgts)
    np.testing.assert_allclose(got, expect, rtol=1e-13, atol=1e-15)


def test_weighted_corr_bitwise_symmetric_case(geno):
    """The combine reproduces the reference association order, so the
    result should be bit-identical to the literal oracle loops."""
    G, pop_sizes, wgts = geno
    got = ldkernels.weighted_corr(G[:8], G[:8], pop_sizes, wgts)
    for i in range(8):
        for j in range(8):
            cov = oracle.cal_wgt_cov(G[i], G[j], pop_sizes, wgts)
            si = np.sqrt(oracle.cal_wgt_cov(G[i], G[i], pop_sizes, wgts))
            sj = np.sqrt(oracle.cal_wgt_cov(G[j], G[j], pop_sizes, wgts))
            assert got[i, j] == pytest.approx(cov / (si * sj), rel=1e-15)


def test_pooled_corr_matches_oracle(geno):
    G, _, _ = geno
    got = ldkernels.pooled_corr(G[:10], G[10:])
    expect = oracle.pooled_corr_matrix(G[:10], G[10:])
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-14)


def test_per_pop_corr_matches_oracle(geno):
    G, pop_sizes, _ = geno
    got = ldkernels.per_pop_corr(G[:9], pop_sizes)
    bounds = np.concatenate([[0], np.cumsum(pop_sizes)])
    for k in range(3):
        seg = slice(bounds[k], bounds[k + 1])
        for i in range(9):
            for j in range(9):
                expect = oracle.cal_cor_single(G[i, seg], G[j, seg])
                np.testing.assert_allclose(got[k, i, j], expect, rtol=1e-13)


def test_constant_snp_gives_nan(geno):
    """Zero-variance SNPs divide by zero, like the reference (0/0)."""
    G, pop_sizes, wgts = geno
    G2 = G.copy()
    G2[0] = 1
    got = ldkernels.pooled_corr(G2[:2], G2[:2])
    assert np.isnan(got[0, 1])
