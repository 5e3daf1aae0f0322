"""End-to-end analysis tests on the synthetic panel: formats -> join ->
decode -> kernels -> output, checked against literal scalar oracles."""

import numpy as np
import pandas as pd
import pytest

import gauss_jax
from gauss_jax.models import pipeline
from gauss_jax.config import PanelFiles
from gauss_jax.io import readers

import oracle

POP_WGT = pd.DataFrame({"pop": ["AAA", "CCC", "EEE"],
                        "wgt": [0.5, 0.3, 0.2]})


@pytest.fixture(scope="module")
def region(synpanel):
    bp = synpanel.index_df["bp"]
    return int(bp.min()), int(bp.max())


def test_compute_ld_matches_oracle(synpanel, gwas_input, region):
    path, truth = gwas_input
    lo, hi = region
    res = gauss_jax.compute_ld(
        22, lo, hi, POP_WGT, path,
        synpanel.files.index_file, synpanel.files.data_file,
        synpanel.files.pop_desc_file)
    snplist, cormat = res["snplist"], res["cormat"]
    M = len(snplist)
    assert cormat.shape == (M, M)
    assert np.all(np.diag(cormat) == 1.0)
    assert np.allclose(cormat, cormat.T)

    # rebuild the genotype block straight from the fixture ground truth
    sel_pops = [0, 2, 4]  # AAA, CCC, EEE panel indices
    b = np.concatenate([[0], np.cumsum(synpanel.desc.sizes)])
    rs2row = {r: i for i, r in enumerate(synpanel.index_df["rsid"])}
    rows = [rs2row[r] for r in snplist["rsid"]]
    G = np.concatenate([synpanel.genotypes[rows][:, b[k]:b[k + 1]]
                        for k in sel_pops], axis=1)
    sizes = [int(synpanel.desc.sizes[k]) for k in sel_pops]
    expect = oracle.weighted_corr_matrix(G[:8], G[:8], sizes, [0.5, 0.3, 0.2])
    np.fill_diagonal(expect, 1.0)
    np.testing.assert_allclose(cormat[:8, :8], expect, rtol=1e-12, atol=1e-13)

    # measured SNPs only, all type 1, af1mix = weighted panel AFs
    af_expect = synpanel.afs[rows][:, sel_pops] @ np.array([0.5, 0.3, 0.2])
    np.testing.assert_allclose(snplist["af1mix"], af_expect, atol=5e-7)


def test_dist_matches_oracle(synpanel, gwas_input, region):
    path, truth = gwas_input
    lo, hi = region
    # prediction window = middle third; wings cover the rest
    p_lo = lo + (hi - lo) // 3
    p_hi = lo + 2 * (hi - lo) // 3
    wing = hi - lo
    res = gauss_jax.dist(
        22, p_lo, p_hi, wing, "EUR", path,
        synpanel.files.index_file, synpanel.files.data_file,
        synpanel.files.pop_desc_file, af1_cutoff=0.01)

    assert set(res["type"]) <= {0, 1, 2}
    assert (res["bp"] >= p_lo).all() and (res["bp"] <= p_hi).all()

    # measured rows carry the TRUE panel-orientation z (flip applied)
    tmap = {(r.chr, r.bp): r.z for r in truth.itertuples()}
    meas = res[res["type"] == 1]
    for r in meas.itertuples():
        assert r.z == pytest.approx(tmap[(r.chr, r.bp)], abs=1e-12)
        assert r.info == 1.0

    # oracle recomputation of the imputation from raw window data
    panel = PanelFiles(synpanel.files.index_file, synpanel.files.data_file,
                       synpanel.files.pop_desc_file)
    inp = readers.read_input_z(path, chrom=22, start_bp=p_lo, end_bp=p_hi,
                               wing_size=wing)
    win = pipeline.load_window(panel, inp, chrom=22, start_bp=p_lo,
                               end_bp=p_hi, wing_size=wing, study_pop="EUR",
                               af1_cutoff=0.01)
    m_rows, u_rows = pipeline.partition_window(win, p_lo, p_hi)
    Gm = pipeline.genotypes_for(win, m_rows)
    Gu = pipeline.genotypes_for(win, u_rows)
    B11 = oracle.pooled_corr_matrix(Gm, Gm)
    B21 = oracle.pooled_corr_matrix(Gu, Gm)
    Z1 = win.table["z"].to_numpy()[m_rows]
    z_exp, info_exp = oracle.run_dist_oracle(B11, B21, Z1)

    imp = res[res["type"] == 0]
    u_bp = win.table["bp"].to_numpy()[u_rows]
    exp_map = {bp: (z, i) for bp, z, i in zip(u_bp, z_exp, info_exp)}
    assert len(imp) == len(u_bp)
    for r in imp.itertuples():
        ez, ei = exp_map[r.bp]
        assert r.z == pytest.approx(ez, rel=1e-9, abs=1e-10)
        assert r.info == pytest.approx(ei, rel=1e-9, abs=1e-10)
        # pval = 2*pnorm(-|z|)
        from scipy.stats import norm
        assert r.pval == pytest.approx(2 * norm.sf(abs(r.z)), rel=1e-12)


def test_distmix_matches_oracle(synpanel, gwas_input, region):
    path, truth = gwas_input
    lo, hi = region
    p_lo = lo + (hi - lo) // 3
    p_hi = lo + 2 * (hi - lo) // 3
    wing = hi - lo
    res = gauss_jax.distmix(
        22, p_lo, p_hi, wing, POP_WGT, path,
        synpanel.files.index_file, synpanel.files.data_file,
        synpanel.files.pop_desc_file, af1_cutoff=0.01)

    panel = PanelFiles(synpanel.files.index_file, synpanel.files.data_file,
                       synpanel.files.pop_desc_file)
    inp = readers.read_input_z(path, chrom=22, start_bp=p_lo, end_bp=p_hi,
                               wing_size=wing)
    win = pipeline.load_window(
        panel, inp, chrom=22, start_bp=p_lo, end_bp=p_hi, wing_size=wing,
        pop_wgt=readers.pop_wgt_map_from_df(POP_WGT), af1_cutoff=0.01)
    m_rows, u_rows = pipeline.partition_window(win, p_lo, p_hi)
    Gm = pipeline.genotypes_for(win, m_rows)
    Gu = pipeline.genotypes_for(win, u_rows)
    sizes = list(win.pop_sizes)
    wgts = list(win.pop_wgts)
    B11 = oracle.weighted_corr_matrix(Gm, Gm, sizes, wgts)
    B21 = oracle.weighted_corr_matrix(Gu, Gm, sizes, wgts)
    Z1 = win.table["z"].to_numpy()[m_rows]
    z_exp, info_exp = oracle.run_dist_oracle(B11, B21, Z1)

    imp = res[res["type"] == 0]
    u_bp = win.table["bp"].to_numpy()[u_rows]
    exp_map = {bp: (z, i) for bp, z, i in zip(u_bp, z_exp, info_exp)}
    assert len(imp) == len(u_bp)
    for r in imp.itertuples():
        ez, ei = exp_map[r.bp]
        assert r.z == pytest.approx(ez, rel=1e-9, abs=1e-10)
        assert r.info == pytest.approx(ei, rel=1e-9, abs=1e-10)


def test_dist_insufficient_snps_raises(synpanel, gwas_input, region):
    path, _ = gwas_input
    lo, hi = region
    with pytest.raises(ValueError, match="Not enough"):
        gauss_jax.dist(22, lo, lo + 2000, 1000, "EUR", path,
                       synpanel.files.index_file, synpanel.files.data_file,
                       synpanel.files.pop_desc_file)
