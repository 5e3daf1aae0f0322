"""Fused window kernel + multi-chip sharding tests (8 virtual CPU devices)."""

import numpy as np
import pytest
import jax

import gauss_jax  # noqa: F401
from gauss_jax.ops.window_kernel import (WindowKernelSpec,
                                         build_window_kernel,
                                         pad_pop_segments)
from gauss_jax.parallel.mesh import (make_mesh, sharded_window_impute,
                                     subject_shard_layout)

import oracle

POP_SIZES = (13, 21, 9)
WGTS = (0.4, 0.35, 0.25)


def _toy(n_windows=2, M=20, U=12, seed=3):
    rng = np.random.default_rng(seed)
    S = sum(POP_SIZES)
    Gm = rng.integers(0, 3, size=(n_windows, M, S), dtype=np.int8)
    Gu = rng.integers(0, 3, size=(n_windows, U, S), dtype=np.int8)
    Z1 = rng.standard_normal((n_windows, M))
    m_mask = np.ones((n_windows, M), dtype=np.float32)
    u_mask = np.ones((n_windows, U), dtype=np.float32)
    m_mask[:, -2:] = 0
    u_mask[:, -1:] = 0
    Gm[:, -2:] = 0
    Gu[:, -1:] = 0
    Z1[:, -2:] = 0
    return Gm, Gu, Z1, m_mask, u_mask


def test_window_kernel_matches_host_oracle():
    Gm, Gu, Z1, m_mask, u_mask = _toy()
    spec = WindowKernelSpec(pop_sizes=POP_SIZES, pop_sizes_padded=POP_SIZES,
                            wgts=WGTS)
    z, info = build_window_kernel(spec)(Gm, Gu, Z1, m_mask, u_mask)
    z, info = np.asarray(z), np.asarray(info)
    for w in range(Gm.shape[0]):
        Mr = int(m_mask[w].sum())
        Ur = int(u_mask[w].sum())
        B11 = oracle.weighted_corr_matrix(Gm[w, :Mr], Gm[w, :Mr],
                                          POP_SIZES, WGTS)
        B21 = oracle.weighted_corr_matrix(Gu[w, :Ur], Gm[w, :Mr],
                                          POP_SIZES, WGTS)
        ze, ie = oracle.run_dist_oracle(B11, B21, Z1[w, :Mr])
        # device kernel does f32 linalg: modest tolerance
        np.testing.assert_allclose(z[w, :Ur], ze, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(info[w, :Ur], ie, rtol=2e-3, atol=2e-4)


def test_window_kernel_unweighted():
    Gm, Gu, Z1, m_mask, u_mask = _toy(seed=5)
    spec = WindowKernelSpec(pop_sizes=POP_SIZES, pop_sizes_padded=POP_SIZES,
                            wgts=None)
    z, info = build_window_kernel(spec)(Gm, Gu, Z1, m_mask, u_mask)
    z = np.asarray(z)
    for w in range(Gm.shape[0]):
        Mr = int(m_mask[w].sum())
        Ur = int(u_mask[w].sum())
        B11 = oracle.pooled_corr_matrix(Gm[w, :Mr], Gm[w, :Mr])
        B21 = oracle.pooled_corr_matrix(Gu[w, :Ur], Gm[w, :Mr])
        ze, _ = oracle.run_dist_oracle(B11, B21, Z1[w, :Mr])
        np.testing.assert_allclose(z[w, :Ur], ze, rtol=2e-3, atol=2e-4)


def test_subject_padding_is_exact():
    """Zero subject columns must change nothing (true pop sizes used)."""
    Gm, Gu, Z1, m_mask, u_mask = _toy(seed=7)
    spec = WindowKernelSpec(pop_sizes=POP_SIZES, pop_sizes_padded=POP_SIZES,
                            wgts=WGTS)
    z0, _ = build_window_kernel(spec)(Gm, Gu, Z1, m_mask, u_mask)

    Gm_p, padded = pad_pop_segments(Gm, POP_SIZES, multiple=8)
    Gu_p, _ = pad_pop_segments(Gu, POP_SIZES, multiple=8)
    spec_p = WindowKernelSpec(pop_sizes=POP_SIZES, pop_sizes_padded=padded,
                              wgts=WGTS)
    z1, _ = build_window_kernel(spec_p)(Gm_p, Gu_p, Z1, m_mask, u_mask)
    # padded columns contribute exactly 0 (coef=0), but the f32 matmul's
    # accumulation order over the longer subject axis differs -> not
    # bitwise, only fp-reordering noise
    np.testing.assert_allclose(np.asarray(z0), np.asarray(z1),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_matches_single_device():
    n_win, n_sub = 2, 4
    mesh = make_mesh(n_win, n_sub)
    Gm, Gu, Z1, m_mask, u_mask = _toy(n_windows=4, seed=11)
    Gm_l, padded, locs = subject_shard_layout(Gm, POP_SIZES, n_sub)
    Gu_l, _, _ = subject_shard_layout(Gu, POP_SIZES, n_sub)
    z, info = sharded_window_impute(
        mesh, Gm_l, Gu_l, Z1, m_mask, u_mask,
        true_pop_sizes=POP_SIZES, local_pop_sizes=locs, wgts=WGTS)
    spec = WindowKernelSpec(pop_sizes=POP_SIZES, pop_sizes_padded=POP_SIZES,
                            wgts=WGTS)
    z1, info1 = build_window_kernel(spec)(Gm, Gu, Z1, m_mask, u_mask)
    real = u_mask > 0
    np.testing.assert_allclose(np.asarray(z)[real], np.asarray(z1)[real],
                               rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(np.asarray(info)[real],
                               np.asarray(info1)[real],
                               rtol=5e-4, atol=5e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_graft_entry_dryrun():
    import sys
    sys.path.insert(0, ".")
    import __graft_entry__ as ge
    fn, args = ge.entry()
    z, info = fn(*args)
    assert np.isfinite(np.asarray(z)[:, :-2]).all()
    ge.dryrun_multichip(8)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_engine_mesh_impute_matches_single_device(synpanel, gwas_input):
    """PRODUCTION mesh path: GenomeEngine.impute_region over a (2 x 4)
    mesh == the 1-device engine at real bucketed shapes (Mp=256)."""
    from gauss_jax.io import readers
    from gauss_jax.models.genome import GenomeEngine, PanelStore

    path, _ = gwas_input
    lo, hi = 1_000_000, 1_299_000
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=0)
    store = PanelStore.from_bgzf(synpanel.files, chrom=22)
    pop_wgt = {p: 1.0 / len(synpanel.desc.pops) for p in synpanel.desc.pops}
    kw = dict(window_bp=75_000, wing_size=40_000)

    mesh = make_mesh(2, 4)
    df_m = (GenomeEngine(store, mesh=mesh).prepare_mix(inp, pop_wgt)
            .impute_region(lo, hi, **kw))
    df_1 = (GenomeEngine(store, device_linalg=True, stats="int8")
            .prepare_mix(inp, pop_wgt).impute_region(lo, hi, **kw))
    assert len(df_m) == len(df_1) > 0
    np.testing.assert_allclose(df_m["z"].to_numpy(), df_1["z"].to_numpy(),
                               rtol=1e-5, atol=5e-6)
    np.testing.assert_allclose(df_m["info"].to_numpy(),
                               df_1["info"].to_numpy(),
                               rtol=1e-5, atol=5e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_engine_mesh_qcat_and_ld_match_single_device(synpanel, gwas_input):
    from gauss_jax.io import readers
    from gauss_jax.models.genome import GenomeEngine, PanelStore

    path, _ = gwas_input
    lo, hi = 1_000_000, 1_299_000
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=0)
    store = PanelStore.from_bgzf(synpanel.files, chrom=22)
    pop_wgt = {p: 1.0 / len(synpanel.desc.pops) for p in synpanel.desc.pops}

    mesh = make_mesh(2, 4)
    run_m = GenomeEngine(store, snp_bucket=64, mesh=mesh).prepare_mix(
        inp, pop_wgt, af1_cutoff=0.05)
    run_1 = GenomeEngine(store, snp_bucket=64, device_linalg=True,
                         stats="int8").prepare_mix(inp, pop_wgt,
                                                   af1_cutoff=0.05)

    q_m = run_m.qcat_region(lo, hi, window_bp=75_000, wing_size=40_000)
    q_1 = run_1.qcat_region(lo, hi, window_bp=75_000, wing_size=40_000)
    assert len(q_m) == len(q_1) > 0
    np.testing.assert_allclose(q_m["qcat_t"].to_numpy(),
                               q_1["qcat_t"].to_numpy(),
                               rtol=1e-4, atol=1e-5)
    assert (q_m["qcat_m"].to_numpy() == q_1["qcat_m"].to_numpy()).all()

    ld_m = run_m.ld_region(lo, hi, window_bp=100_000)
    ld_1 = run_1.ld_region(lo, hi, window_bp=100_000)
    assert len(ld_m) == len(ld_1) > 0
    for a, b in zip(ld_m, ld_1):
        assert (a["snplist"]["rsid"].to_numpy()
                == b["snplist"]["rsid"].to_numpy()).all()
        # both sides quantize independently (default i16tri fetch), so
        # the worst case is one LSB apart on top of the stats tolerance
        np.testing.assert_allclose(a["cormat"], b["cormat"],
                                   rtol=1e-5, atol=4e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_region_matches_single_device():
    """Whole-region scan over a (window x subject) mesh == 1-device scan."""
    from gauss_jax.ops.window_kernel import build_region_kernel
    from gauss_jax.parallel.mesh import sharded_region_impute

    n_win, n_sub = 2, 4
    mesh = make_mesh(n_win, n_sub)
    rng = np.random.default_rng(21)
    R, Mp, Up, W = 300, 24, 16, 4
    S = sum(POP_SIZES)
    G = rng.integers(0, 3, size=(R, S), dtype=np.int8)
    m_idx = rng.integers(0, R, size=(W, Mp)).astype(np.int32)
    u_idx = rng.integers(0, R, size=(W, Up)).astype(np.int32)
    Z1 = rng.standard_normal((W, Mp))
    m_mask = np.ones((W, Mp), np.float32)
    u_mask = np.ones((W, Up), np.float32)
    m_mask[:, -3:] = 0
    u_mask[:, -2:] = 0
    Z1[:, -3:] = 0

    G_l, padded, locs = subject_shard_layout(G, POP_SIZES, n_sub)
    z, info = sharded_region_impute(
        mesh, G_l, m_idx, u_idx, Z1, m_mask, u_mask,
        true_pop_sizes=POP_SIZES, local_pop_sizes=locs, wgts=WGTS)

    spec = WindowKernelSpec(pop_sizes=POP_SIZES, pop_sizes_padded=POP_SIZES,
                            wgts=WGTS)
    z1, info1 = build_region_kernel(spec)(G, m_idx, u_idx, Z1,
                                          m_mask, u_mask)
    real = u_mask > 0
    np.testing.assert_allclose(np.asarray(z)[real], np.asarray(z1)[real],
                               rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(np.asarray(info)[real],
                               np.asarray(info1)[real],
                               rtol=5e-4, atol=5e-5)
