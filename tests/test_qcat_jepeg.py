"""qcat/qcatmix/prep_qcat/prep_recessive_impute and jepeg/jepegmix tests."""

import numpy as np
import pandas as pd
import pytest

import gauss_jax
from gauss_jax.config import PanelFiles
from gauss_jax.io import readers
from gauss_jax.models import pipeline
from gauss_jax.utils import testing as gtest

import oracle

POP_WGT = pd.DataFrame({"pop": ["AAA", "BBB", "EEE"],
                        "wgt": [0.4, 0.35, 0.25]})


@pytest.fixture(scope="module")
def region(synpanel):
    bp = synpanel.index_df["bp"]
    return int(bp.min()), int(bp.max())


@pytest.fixture(scope="module")
def annot_file(synpanel, tmp_path_factory):
    d = tmp_path_factory.mktemp("annot")
    path = str(d / "annot.txt")
    gtest.make_annotation(synpanel, path)
    return path


def test_qcat_matches_oracle(synpanel, gwas_input, region):
    path, truth = gwas_input
    lo, hi = region
    p_lo = lo + (hi - lo) // 3
    p_hi = lo + 2 * (hi - lo) // 3
    wing = hi - lo
    res = gauss_jax.qcat(22, p_lo, p_hi, wing, "EUR", path,
                         synpanel.files.index_file, synpanel.files.data_file,
                         synpanel.files.pop_desc_file)
    assert {"qcat_m", "qcat_t", "qcat_chisq", "qcat_pval"} <= set(res.columns)
    assert (res["bp"] >= p_lo).all() and (res["bp"] <= p_hi).all()

    # oracle recomputation (af1_cutoff default 0.05 for qcat)
    panel = PanelFiles(synpanel.files.index_file, synpanel.files.data_file,
                       synpanel.files.pop_desc_file)
    inp = readers.read_input_z(path, chrom=22, start_bp=p_lo, end_bp=p_hi,
                               wing_size=wing)
    win = pipeline.load_window(panel, inp, chrom=22, start_bp=p_lo,
                               end_bp=p_hi, wing_size=wing, study_pop="EUR",
                               af1_cutoff=0.05)
    m_rows, u_rows = pipeline.partition_window(win, p_lo, p_hi)
    Gm = pipeline.genotypes_for(win, m_rows)
    Gu = pipeline.genotypes_for(win, u_rows)
    B11 = oracle.pooled_corr_matrix(Gm, Gm)
    B21 = oracle.pooled_corr_matrix(Gu, Gm)
    Z1 = win.table["z"].to_numpy()[m_rows]
    bp_m = win.table["bp"].to_numpy()[m_rows]
    headwing = int((bp_m < p_lo).sum())
    n_pred_meas = int(((bp_m >= p_lo) & (bp_m <= p_hi)).sum())
    num_eig, t_m, c_m, t_u, c_u = oracle.run_qcat_oracle(
        B11, B21, Z1, headwing, n_pred_meas)

    meas = res[res["type"] == 1]
    assert (meas["qcat_m"] == num_eig).all()
    np.testing.assert_allclose(meas["qcat_t"], t_m, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(meas["qcat_chisq"], c_m, rtol=1e-8, atol=1e-10)
    unm = res[res["type"] == 0]
    np.testing.assert_allclose(unm["qcat_t"], t_u, rtol=1e-8, atol=1e-10)
    # pval = pchisq upper tail with df=1
    from scipy.stats import chi2
    np.testing.assert_allclose(res["qcat_pval"],
                               chi2.sf(res["qcat_chisq"], 1), rtol=1e-10)


def test_qcatmix_runs(synpanel, gwas_input, region):
    path, _ = gwas_input
    lo, hi = region
    p_lo = lo + (hi - lo) // 3
    p_hi = lo + 2 * (hi - lo) // 3
    res = gauss_jax.qcatmix(22, p_lo, p_hi, hi - lo, POP_WGT, path,
                            synpanel.files.index_file,
                            synpanel.files.data_file,
                            synpanel.files.pop_desc_file)
    assert len(res) > 0
    tested = res[res["type"] != 2]
    assert (tested["qcat_m"] > 0).all()
    assert np.isfinite(tested["qcat_chisq"]).all()


def test_prep_qcat_structure(synpanel, gwas_input, region):
    path, _ = gwas_input
    lo, hi = region
    p_lo = lo + (hi - lo) // 3
    p_hi = lo + 2 * (hi - lo) // 3
    out = gauss_jax.prep_qcat(22, p_lo, p_hi, hi - lo, "EUR", path,
                              synpanel.files.index_file,
                              synpanel.files.data_file,
                              synpanel.files.pop_desc_file)
    M = len(out["z_vec"])
    snp = out["snplist"]
    assert out["cor_mat1"].shape == (M, M)
    assert np.all(np.diag(out["cor_mat1"]) == 1.0)  # no ridge in prep
    n_pred = ((snp["type"] != 2) & (snp["bp"] >= p_lo)
              & (snp["bp"] <= p_hi)).sum()
    assert out["cor_mat2"].shape == (n_pred, M)
    # snplist includes the whole extended window
    assert (snp["bp"] < p_lo).any() or (snp["bp"] > p_hi).any()


def test_prep_recessive_impute(synpanel, gwas_input, region):
    path, _ = gwas_input
    lo, hi = region
    p_lo = lo + (hi - lo) // 3
    p_hi = lo + 2 * (hi - lo) // 3
    out = gauss_jax.prep_recessive_impute(
        22, p_lo, p_hi, hi - lo, POP_WGT, path,
        synpanel.files.index_file, synpanel.files.data_file,
        synpanel.files.pop_desc_file)
    snp = out["snplist"]
    # minor-allele normalization: all af1mix <= 0.5
    assert (snp["af1mix"] <= 0.5 + 1e-12).all()
    U, M = out["cormat_add"].shape
    assert out["cormat"].shape == (M, M)
    assert out["cormat_dom"].shape == (U, M)
    assert out["cormat_rec"].shape == (U, M)
    assert len(snp) == U
    # additive self-block: pred SNPs that are measured appear in both
    # windows; their additive corr against themselves must be ~1
    fin = np.isfinite(out["cormat_add"])
    assert (np.abs(out["cormat_add"][fin]) <= 1 + 1e-9).all()


def test_jepeg_matches_oracle(synpanel, gwas_input, annot_file):
    path, truth = gwas_input
    res = gauss_jax.jepeg("EUR", path, annot_file,
                          synpanel.files.index_file,
                          synpanel.files.data_file,
                          synpanel.files.pop_desc_file)
    assert list(res.columns) == ["geneid", "chisq", "df", "jepeg_pval",
                                 "num_snp", "top_categ", "top_categ_pval",
                                 "top_snp", "top_snp_pval"]
    assert len(res) > 0
    tested = res[res["df"] > 0]
    assert len(tested) > 0
    assert (tested["chisq"] > 0).all()
    assert ((tested["jepeg_pval"] >= 0) & (tested["jepeg_pval"] <= 1)).all()

    # oracle re-check of each tested gene, rebuilt from fixture data
    panel = PanelFiles(synpanel.files.index_file, synpanel.files.data_file,
                       synpanel.files.pop_desc_file)
    from gauss_jax.core import variants
    from gauss_jax.io.panel import PanelReader, read_panel_index
    inp = readers.read_input_z(path, all_snps=True)
    idx = read_panel_index(panel.index_file)
    table = variants.join_reference_index(inp, idx, add_unmeasured=False,
                                          flip_af1study=True)
    annot = readers.read_annotation(annot_file)
    table, categs = variants.join_annotation(table, annot)
    desc = readers.read_pop_desc(panel.pop_desc_file)
    flags = readers.init_pop_flags(desc, "EUR")
    reader = PanelReader(panel.data_file, desc)
    has_row = table["fpos"].to_numpy() >= 0
    dec = reader.decode_rows(table["fpos"].to_numpy()[has_row],
                             pop_flags=flags)
    g_row = np.full(len(table), -1, dtype=np.int64)
    g_row[has_row] = np.arange(int(has_row.sum()))
    counts = dec.G.astype(np.int64).sum(axis=1)
    af = counts / (2.0 * float(dec.pop_sizes.sum()))
    af = np.ceil(af * 1e5) / 1e5
    keep = np.zeros(len(table), dtype=bool)
    keep[has_row] = (af > 0.01) & (af < 0.99)

    cw = np.zeros((len(table), 6))
    cp = np.zeros((len(table), 6), dtype=bool)
    r = categs["row"].to_numpy(dtype=np.int64)
    c = categs["categ"].to_numpy(dtype=np.int64)
    cw[r, c] = categs["wgt"].to_numpy()
    cp[r, c] = True

    checked = 0
    for gene in res["geneid"]:
        if gene == ".":
            continue
        rows = np.flatnonzero(keep & (table["geneid"].to_numpy() == gene)
                              & (table["type"].to_numpy() == 1))
        G = dec.G[g_row[rows]]
        CorG = oracle.pooled_corr_matrix(G, G)
        z = table["z"].to_numpy()[rows]
        info = table["info"].to_numpy()[rows]
        chisq, df = oracle.jepeg_gene_oracle(CorG, z, info, cw[rows], cp[rows])
        row = res[res["geneid"] == gene].iloc[0]
        assert row["df"] == df
        assert row["chisq"] == pytest.approx(chisq, rel=1e-8)
        checked += 1
    assert checked >= 3


def test_jepegmix_runs(synpanel, gwas_input, annot_file):
    path, _ = gwas_input
    res = gauss_jax.jepegmix(POP_WGT, path, annot_file,
                             synpanel.files.index_file,
                             synpanel.files.data_file,
                             synpanel.files.pop_desc_file)
    assert len(res) > 0
    tested = res[res["df"] > 0]
    assert len(tested) > 0
    # mix chisq should differ from homogeneous but be in a sane range
    assert np.isfinite(tested["chisq"]).all()


def test_gene_stats_resident_pad_row_nan_safe():
    """Pad rows of a gene bucket gather panel row 0; if that row is
    monomorphic its correlations are NaN and must NOT poison CovU/U
    through the W contraction (regression: round-3 advisor finding).
    Real-SNP NaNs still propagate (reference divides by zero,
    src/util.cpp:63-69)."""
    import jax.numpy as jnp
    from gauss_jax.core import genekernels

    rng = np.random.default_rng(7)
    S = 40
    pop_sizes = (24, 16)
    G = rng.integers(0, 3, size=(10, S)).astype(np.int8)
    G[0] = 1                       # monomorphic row 0 -> NaN correlations
    G_dev = jnp.asarray(G)

    n_g = 3                        # bucket 8 -> 5 pad rows gather row 0
    gene_idx = [np.array([2, 5, 7], dtype=np.int32)]
    W = rng.normal(size=(6, n_g))
    z = rng.normal(size=n_g)

    for wgts in (None, (0.6, 0.4)):
        stats6 = genekernels.gene_stats_resident(
            G_dev, gene_idx, [W], [z], pop_sizes, wgts, lam=0.1)
        CovU, WWt, U = stats6[0]
        assert np.isfinite(CovU).all()
        assert np.isfinite(WWt).all()
        assert np.isfinite(U).all()

        # parity vs dense host contraction on the unpadded block
        corr = genekernels.gene_corr_matrices([G[gene_idx[0]]],
                                              pop_sizes, wgts)[0].copy()
        np.fill_diagonal(corr, 1.1)
        np.testing.assert_allclose(CovU, W @ corr @ W.T, atol=1e-10)
        np.testing.assert_allclose(U, W @ z, atol=1e-12)


def test_gene_batching_admits_oversized_gene():
    """A gene whose own bucket exceeds max_batch_elems must still be
    admitted (alone) rather than spinning the batching loop forever
    (regression: round-3 advisor finding)."""
    import jax.numpy as jnp
    from gauss_jax.core import genekernels

    rng = np.random.default_rng(3)
    S = 64
    pop_sizes = (40, 24)
    G = rng.integers(0, 3, size=(20, S)).astype(np.int8)
    G_dev = jnp.asarray(G)
    gene_idx = [np.arange(12, dtype=np.int32),      # bucket 16
                np.array([1, 2, 3], dtype=np.int32)]
    Ws = [rng.normal(size=(6, len(g))) for g in gene_idx]
    zs = [rng.normal(size=len(g)) for g in gene_idx]

    # 1 * 16 * 64 = 1024 > 512: per-gene cap exceeded for gene 0
    stats6 = genekernels.gene_stats_resident(
        G_dev, gene_idx, Ws, zs, pop_sizes, None, lam=0.1,
        max_batch_elems=512)
    assert len(stats6) == 2 and all(s is not None for s in stats6)

    corrs = genekernels.gene_corr_matrices(
        [G[g] for g in gene_idx], pop_sizes, None, max_batch_elems=512)
    for (CovU, WWt, U), W, z, corr in zip(stats6, Ws, zs, corrs):
        c = corr.copy()
        np.fill_diagonal(c, 1.1)
        np.testing.assert_allclose(CovU, W @ c @ W.T, atol=1e-10)

    out = genekernels.gene_corr_resident(G_dev, gene_idx, pop_sizes,
                                         None, max_batch_elems=512)
    for a, b in zip(out, corrs):
        np.testing.assert_allclose(a, b, atol=1e-12)
