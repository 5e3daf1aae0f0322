"""Edge-case parity: host f64 path vs fused device path must agree (or
fail identically with the reference's guard, src/dist.cpp:145-151) on
the boundary cases where padding/masking bugs live.
"""

import numpy as np
import pandas as pd
import pytest

import gauss_jax
from gauss_jax.config import PanelFiles
from gauss_jax.io import readers
from gauss_jax.io.panel import write_panel
from gauss_jax.io.readers import PopDesc
from gauss_jax.models.genome import GenomeEngine, PanelStore


N_SNPS = 160
BP0, STEP = 1_000_000, 1_000


@pytest.fixture(scope="module")
def edge_panel(tmp_path_factory):
    """Hand-crafted panel: blocks of SNPs monomorphic within ONE
    population (zero per-pop variance -- the reference's per-pop
    d-term is 0 there, src/util.cpp:103-124) but polymorphic overall,
    so the mix AF filter keeps them."""
    rng = np.random.default_rng(303)
    desc = PopDesc(pops=["PPA", "PPB", "PPC"],
                   sizes=np.array([30, 40, 20], dtype=np.int64),
                   sup_pops=["EUR", "EUR", "AFR"])
    S = int(desc.sizes.sum())
    G = rng.integers(0, 3, size=(N_SNPS, S), dtype=np.int8)
    # LD structure so imputation has signal
    for i in range(1, N_SNPS):
        keep = rng.random(S) < 0.85
        G[i, keep] = G[i - 1, keep]
    # monomorphic-in-PPA block (all ref) and monomorphic-in-PPB (all 2)
    G[10:20, :30] = 0
    G[20:25, 30:70] = 2
    alleles = np.array(["A", "C", "G", "T"])
    a1 = alleles[rng.integers(0, 4, N_SNPS)]
    a2 = np.where(a1 == "A", "C", "A")
    index_df = pd.DataFrame({
        "rsid": [f"rs9{i:05d}" for i in range(N_SNPS)],
        "chr": np.full(N_SNPS, 22, dtype=np.int32),
        "bp": BP0 + STEP * np.arange(N_SNPS, dtype=np.int64),
        "a1": a1, "a2": a2,
    })
    d = tmp_path_factory.mktemp("edgepanel")
    idx_f, dat_f, pd_f = write_panel(str(d / "edge"), desc, index_df, G)
    return PanelFiles(idx_f, dat_f, pd_f), index_df, G, desc


def _z_input(index_df, measured_rows, tmp_path, seed=5):
    rng = np.random.default_rng(seed)
    path = str(tmp_path / "zin.txt")
    with open(path, "w") as fh:
        fh.write("rsid chr bp a1 a2 z\n")
        for i in measured_rows:
            r = index_df.iloc[i]
            fh.write(f"{r.rsid}x {r.chr} {r.bp} {r.a1} {r.a2} "
                     f"{rng.standard_normal() * 1.2:.6f}\n")
    return path


WGT = {"PPA": 0.5, "PPB": 0.3, "PPC": 0.2}


def test_monomorphic_within_pop_parity(edge_panel, tmp_path):
    """Windows covering the monomorphic-within-pop blocks: device and
    host paths must agree and stay finite."""
    files, index_df, G, desc = edge_panel
    measured = np.arange(0, N_SNPS, 2)     # unmeasured = odd rows,
    path = _z_input(index_df, measured, tmp_path)   # incl. 11..23
    inp = readers.read_input_z(path, all_snps=True)
    store = PanelStore.from_bgzf(files)

    lo, hi = BP0, BP0 + STEP * (N_SNPS - 1)
    run_h = GenomeEngine(store, snp_bucket=64).prepare_mix(inp, WGT)
    run_d = GenomeEngine(store, snp_bucket=64,
                         device_linalg=True).prepare_mix(inp, WGT)
    a = run_h.impute_window(lo, hi, STEP * 30).table
    b = run_d.impute_window(lo, hi, STEP * 30).table
    # the monomorphic-block SNPs must actually be in the output
    bps = a["bp"].to_numpy()
    assert ((bps >= BP0 + 10 * STEP) & (bps <= BP0 + 24 * STEP)).sum() >= 10
    assert np.isfinite(a["z"].to_numpy()).all()
    assert np.isfinite(b["z"].to_numpy()).all()
    imp = a["type"].to_numpy() == 0
    np.testing.assert_allclose(b["z"].to_numpy()[imp],
                               a["z"].to_numpy()[imp],
                               rtol=2e-3, atol=2e-4)
    # cross-check vs the per-call reference-semantics path
    ref = gauss_jax.distmix(22, lo, hi, STEP * 30,
                            pd.DataFrame({"pop": list(WGT),
                                          "wgt": list(WGT.values())}),
                            path, files.index_file, files.data_file,
                            files.pop_desc_file)
    m = ref.merge(a, on=["rsid", "bp"], suffixes=("_r", "_h"))
    assert len(m) == len(ref)
    np.testing.assert_allclose(m["z_h"], m["z_r"], rtol=1e-9, atol=1e-11)


def test_single_pop_weights_match_dist(edge_panel, tmp_path):
    """pop_wgt = {one pop: 1.0}: the weighted estimator collapses to the
    pooled correlation over that population, so distmix z must match
    dist z on shared rows (AF filters differ only by ceil rounding)."""
    files, index_df, G, desc = edge_panel
    measured = np.arange(0, N_SNPS, 2)
    path = _z_input(index_df, measured, tmp_path)
    lo, hi = BP0 + 30 * STEP, BP0 + 120 * STEP
    wing = 30 * STEP
    mix = gauss_jax.distmix(22, lo, hi, wing,
                            pd.DataFrame({"pop": ["PPB"], "wgt": [1.0]}),
                            path, files.index_file, files.data_file,
                            files.pop_desc_file)
    hom = gauss_jax.dist(22, lo, hi, wing, "PPB", path,
                         files.index_file, files.data_file,
                         files.pop_desc_file)
    m = mix.merge(hom, on=["rsid", "bp"], suffixes=("_m", "_h"))
    assert len(m) > 50
    imp = m["type_m"].to_numpy() == 0
    # same windows only if the AF-kept sets coincide; restrict to rows
    # where both kept everything between them
    if len(m) == len(mix) == len(hom):
        np.testing.assert_allclose(m["z_m"].to_numpy()[imp],
                                   m["z_h"].to_numpy()[imp],
                                   rtol=1e-6, atol=1e-8)
    else:
        # AF rounding moved the keep set; still require finite + sane
        assert np.isfinite(m["z_m"].to_numpy()).all()


def test_min_count_boundary(edge_panel, tmp_path):
    """M or U exactly at the reference minimum: per-call host path
    raises the reference guard (src/dist.cpp:145-151), the engine
    returns None for the window / an empty region frame.  One more SNP
    on each side and both paths succeed with parity."""
    files, index_df, G, desc = edge_panel
    # exactly 11 measured (M=11 > 10 passes; use window slicing to hit
    # the boundary): measured rows 0..10, unmeasured 11..21
    measured = np.arange(0, 11)
    path = _z_input(index_df, measured, tmp_path)
    inp = readers.read_input_z(path, all_snps=True)
    store = PanelStore.from_bgzf(files)
    wing = STEP * N_SNPS

    # prediction window holding exactly 10 unmeasured rows -> U == 10
    # fails the strict > check on both paths
    lo = BP0 + 11 * STEP
    hi_fail = BP0 + 20 * STEP     # rows 11..20 = 10 unmeasured
    hi_ok = BP0 + 21 * STEP       # rows 11..21 = 11 unmeasured
    with pytest.raises(ValueError, match="[Nn]ot enough|insufficient"):
        gauss_jax.distmix(22, lo, hi_fail, wing,
                          pd.DataFrame({"pop": list(WGT),
                                        "wgt": list(WGT.values())}),
                          path, files.index_file, files.data_file,
                          files.pop_desc_file)
    run = GenomeEngine(store, snp_bucket=64,
                       device_linalg=True).prepare_mix(inp, WGT)
    assert run.impute_window(lo, hi_fail, wing) is None
    assert len(run.impute_region(lo, hi_fail, window_bp=10 * STEP,
                                 wing_size=wing)) == 0

    # one more unmeasured row: both paths succeed and agree
    ref = gauss_jax.distmix(22, lo, hi_ok, wing,
                            pd.DataFrame({"pop": list(WGT),
                                          "wgt": list(WGT.values())}),
                            path, files.index_file, files.data_file,
                            files.pop_desc_file)
    res = run.impute_window(lo, hi_ok, wing)
    assert res is not None and len(res.table) == len(ref)
    imp = ref["type"].to_numpy() == 0
    np.testing.assert_allclose(res.table["z"].to_numpy()[imp],
                               ref["z"].to_numpy()[imp],
                               rtol=2e-3, atol=2e-4)

    # M boundary: only 10 measured in the extended window
    short_wing = 0
    lo2, hi2 = BP0, BP0 + 30 * STEP   # ext window = pred window
    m10 = _z_input(index_df, np.arange(0, 10), tmp_path, seed=6)
    with pytest.raises(ValueError, match="[Nn]ot enough|insufficient"):
        gauss_jax.distmix(22, lo2, hi2, short_wing,
                          pd.DataFrame({"pop": list(WGT),
                                        "wgt": list(WGT.values())}),
                          m10, files.index_file, files.data_file,
                          files.pop_desc_file)
    inp10 = readers.read_input_z(m10, all_snps=True)
    run10 = GenomeEngine(store, snp_bucket=64,
                         device_linalg=True).prepare_mix(inp10, WGT)
    assert run10.impute_window(lo2, hi2, short_wing) is None


def test_window_with_zero_unmeasured(edge_panel, tmp_path):
    """Every panel SNP measured -> U = 0: host path raises, engine
    skips the window."""
    files, index_df, G, desc = edge_panel
    path = _z_input(index_df, np.arange(N_SNPS), tmp_path, seed=7)
    inp = readers.read_input_z(path, all_snps=True)
    store = PanelStore.from_bgzf(files)
    lo, hi = BP0, BP0 + STEP * (N_SNPS - 1)
    with pytest.raises(ValueError, match="[Nn]ot enough|insufficient"):
        gauss_jax.distmix(22, lo, hi, STEP * 10,
                          pd.DataFrame({"pop": list(WGT),
                                        "wgt": list(WGT.values())}),
                          path, files.index_file, files.data_file,
                          files.pop_desc_file)
    run = GenomeEngine(store, snp_bucket=64,
                       device_linalg=True).prepare_mix(inp, WGT)
    assert run.impute_window(lo, hi, STEP * 10) is None


def test_zero_variance_nan_propagation(edge_panel, tmp_path):
    """A SNP that is constant-heterozygous (dosage 1 for every subject
    in every pop) has af=0.5 (passes the cutoff) but zero variance:
    the correlation normalization divides 0/0 and the NaN propagates
    to its row/column -- the reference's exact behavior (CalCor
    src/util.cpp:63-69; SNP_STD_VEC division src/distmix.cpp:188-200).
    Other SNPs stay clean, and no RuntimeWarning escapes
    (core/ldkernels.py silences the incidental numpy warning)."""
    import warnings

    from gauss_jax.core import ldkernels

    files, index_df, G, desc = edge_panel
    Gz = G[:12].copy()
    Gz[5, :] = 1                       # constant heterozygous
    sizes = list(desc.sizes)
    wgts = [0.4, 0.35, 0.25]
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # any warning -> failure
        corr = ldkernels.weighted_corr(Gz, Gz, sizes, wgts)
    bad = ~np.isfinite(corr)
    assert bad[5].all() and bad[:, 5].all()      # NaN row + column
    keep = np.ones(len(Gz), dtype=bool)
    keep[5] = False
    assert np.isfinite(corr[np.ix_(keep, keep)]).all()

    # pooled (dist) estimator: same propagation contract
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pc = ldkernels.pooled_corr(Gz, Gz)
    assert not np.isfinite(pc[5, 0])
    assert np.isfinite(pc[np.ix_(keep, keep)]).all()
