"""Genome engine: windowed runs must match the per-call API."""

import numpy as np
import pandas as pd
import pytest

import gauss_jax
from gauss_jax.config import PanelFiles
from gauss_jax.io import readers
from gauss_jax.models.genome import GenomeEngine, PanelStore

POP_WGT = pd.DataFrame({"pop": ["AAA", "CCC", "EEE"],
                        "wgt": [0.5, 0.3, 0.2]})


@pytest.fixture(scope="module")
def store(synpanel):
    return PanelStore.from_bgzf(PanelFiles(
        synpanel.files.index_file, synpanel.files.data_file,
        synpanel.files.pop_desc_file))


def test_store_roundtrip(store, synpanel, tmp_path):
    np.testing.assert_array_equal(store.G, synpanel.genotypes)
    store.save(str(tmp_path / "cache"))
    loaded = PanelStore.load(str(tmp_path / "cache"))
    np.testing.assert_array_equal(loaded.G, store.G)
    assert (loaded.index["rsid"] == store.index["rsid"]).all()


def test_engine_matches_percall_distmix(store, synpanel, gwas_input):
    path, truth = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    p_lo = lo + (hi - lo) // 3
    p_hi = lo + 2 * (hi - lo) // 3
    wing = hi - lo

    ref = gauss_jax.distmix(22, p_lo, p_hi, wing, POP_WGT, path,
                            synpanel.files.index_file,
                            synpanel.files.data_file,
                            synpanel.files.pop_desc_file, af1_cutoff=0.01)

    eng = GenomeEngine(store, snp_bucket=64)
    inp = readers.read_input_z(path, all_snps=True)
    run = eng.prepare_mix(inp, readers.pop_wgt_map_from_df(POP_WGT),
                          af1_cutoff=0.01)
    res = run.impute_window(p_lo, p_hi, wing).table

    assert len(res) == len(ref)
    np.testing.assert_array_equal(res["rsid"].to_numpy(),
                                  ref["rsid"].to_numpy())
    np.testing.assert_allclose(res["z"], ref["z"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(res["info"], ref["info"], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(res["af1mix"], ref["af1mix"], rtol=1e-12)


def test_engine_device_linalg_close(store, synpanel, gwas_input):
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    p_lo = lo + (hi - lo) // 3
    p_hi = lo + 2 * (hi - lo) // 3
    wing = hi - lo
    inp = readers.read_input_z(path, all_snps=True)

    eng_h = GenomeEngine(store, snp_bucket=64, device_linalg=False)
    eng_d = GenomeEngine(store, snp_bucket=64, device_linalg=True)
    rh = eng_h.prepare_mix(inp, readers.pop_wgt_map_from_df(POP_WGT))
    rd = eng_d.prepare_mix(inp, readers.pop_wgt_map_from_df(POP_WGT))
    a = rh.impute_window(p_lo, p_hi, wing).table
    b = rd.impute_window(p_lo, p_hi, wing).table
    imp = a["type"].to_numpy() == 0
    dz = np.abs(a["z"].to_numpy()[imp] - b["z"].to_numpy()[imp])
    assert dz.max() < 5e-3  # f32 linalg vs f64 host linalg


def test_engine_region_tiling(store, synpanel, gwas_input):
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    eng = GenomeEngine(store, snp_bucket=64)
    inp = readers.read_input_z(path, all_snps=True)
    run = eng.prepare_mix(inp, readers.pop_wgt_map_from_df(POP_WGT))
    span = hi - lo + 1
    res = run.impute_region(lo, hi, window_bp=span // 2 + 1,
                            wing_size=span)
    # two windows tile the region: every kept SNP appears exactly once
    assert res["bp"].is_unique
    assert res["bp"].min() >= lo and res["bp"].max() <= hi


def test_engine_ld_window_matches_compute_ld(store, synpanel, gwas_input):
    """Device ld_window == host compute_ld (computeLD semantics)."""
    from gauss_jax.io import readers

    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo = int(bp.min())
    hi = lo + (int(bp.max()) - lo) // 2

    host = gauss_jax.compute_ld(
        22, lo, hi, POP_WGT, path,
        synpanel.files.index_file, synpanel.files.data_file,
        synpanel.files.pop_desc_file, af1_cutoff=0.01)

    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=0)
    pop_wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    eng = GenomeEngine(store, snp_bucket=64, device_linalg=True)
    run = eng.prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    dev = run.ld_window(lo, hi)

    assert list(dev["snplist"]["rsid"]) == list(host["snplist"]["rsid"])
    np.testing.assert_allclose(dev["cormat"], host["cormat"],
                               rtol=2e-4, atol=2e-4)


def test_engine_qcat_region_matches_qcatmix(store, synpanel, gwas_input):
    """Device qcat_region == host qcatmix per window."""
    from gauss_jax.io import readers

    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    p_lo = lo + (hi - lo) // 3
    p_hi = lo + 2 * (hi - lo) // 3
    wing = (hi - lo) // 3

    host = gauss_jax.qcatmix(22, p_lo, p_hi, wing, POP_WGT, path,
                             synpanel.files.index_file,
                             synpanel.files.data_file,
                             synpanel.files.pop_desc_file,
                             af1_cutoff=0.05)

    inp = readers.read_input_z(path, chrom=22, start_bp=p_lo, end_bp=p_hi,
                               wing_size=wing)
    pop_wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    eng = GenomeEngine(store, snp_bucket=64, device_linalg=True)
    run = eng.prepare_mix(inp, pop_wgt, af1_cutoff=0.05)
    dev = run.qcat_region(p_lo, p_hi, window_bp=p_hi - p_lo + 1,
                          wing_size=wing)

    m = dev.merge(host, on=["rsid", "chr", "bp", "a1", "a2"],
                  suffixes=("_d", "_h"))
    assert len(m) == len(host)
    assert (m["qcat_m_d"] == m["qcat_m_h"]).all()
    np.testing.assert_allclose(m["qcat_t_d"], m["qcat_t_h"],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(m["qcat_chisq_d"], m["qcat_chisq_h"],
                               rtol=5e-4, atol=5e-4)


def test_region_determinism(store, synpanel, gwas_input):
    """Two identical region runs are byte-deterministic (the replacement
    for race detection in a single-process framework: no run-to-run
    nondeterminism from reductions or scheduling)."""
    from gauss_jax.io import readers

    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=0)
    pop_wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    eng = GenomeEngine(store, snp_bucket=64, device_linalg=True)
    run = eng.prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    wbp = (hi - lo) // 3 + 1
    a = run.impute_region(lo, hi, window_bp=wbp, wing_size=wbp // 2)
    b = run.impute_region(lo, hi, window_bp=wbp, wing_size=wbp // 2)
    assert a.equals(b)


def test_engine_homog_matches_percall_dist(store, synpanel, gwas_input):
    """Unweighted (dist) engine path == per-call dist host results."""
    from gauss_jax.io import readers

    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    p_lo = lo + (hi - lo) // 3
    p_hi = lo + 2 * (hi - lo) // 3
    wing = hi - lo

    ref = gauss_jax.dist(22, p_lo, p_hi, wing, "EUR", path,
                         synpanel.files.index_file,
                         synpanel.files.data_file,
                         synpanel.files.pop_desc_file, af1_cutoff=0.01)

    inp = readers.read_input_z(path, chrom=22, start_bp=p_lo, end_bp=p_hi,
                               wing_size=wing)
    eng = GenomeEngine(store, snp_bucket=64, device_linalg=True)
    run = eng.prepare_homog(inp, "EUR", af1_cutoff=0.01)
    dev = run.impute_region(p_lo, p_hi, window_bp=p_hi - p_lo + 1,
                            wing_size=wing)

    m = dev.merge(ref, on=["rsid", "chr", "bp", "a1", "a2"],
                  suffixes=("_d", "_h"))
    assert len(m) == len(ref)
    imp = m["type_d"] == 0
    np.testing.assert_allclose(m.loc[imp, "z_d"], m.loc[imp, "z_h"],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(m.loc[imp, "info_d"], m.loc[imp, "info_h"],
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# Engine-resident jepeg/jepegmix
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def annot_file_g(synpanel, tmp_path_factory):
    from gauss_jax.utils import testing as gtest
    d = tmp_path_factory.mktemp("annot_g")
    path = str(d / "annot.txt")
    gtest.make_annotation(synpanel, path)
    return path


def _gene_sorted(df):
    return df.sort_values("geneid").reset_index(drop=True)


def test_engine_resident_jepeg_parity(store, synpanel, gwas_input,
                                      annot_file_g):
    """PreparedGenes.jepeg_region (one panel decode, on-device gene
    gather) must reproduce the per-call host jepeg path exactly."""
    path, _ = gwas_input
    host = gauss_jax.jepeg("EUR", path, annot_file_g,
                           synpanel.files.index_file,
                           synpanel.files.data_file,
                           synpanel.files.pop_desc_file)
    eng = GenomeEngine(store)
    inp = readers.read_input_z(path, all_snps=True)
    annot = readers.read_annotation(annot_file_g)
    res = eng.prepare_genes(inp, annot, study_pop="EUR").jepeg_region()
    host, res = _gene_sorted(host), _gene_sorted(res)
    assert list(host["geneid"]) == list(res["geneid"])
    np.testing.assert_allclose(res["chisq"], host["chisq"],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(res["df"], host["df"])
    np.testing.assert_allclose(res["jepeg_pval"], host["jepeg_pval"],
                               rtol=1e-9, atol=1e-12)
    assert list(res["top_categ"]) == list(host["top_categ"])
    assert list(res["top_snp"]) == list(host["top_snp"])


def test_engine_resident_jepegmix_parity_and_chunking(
        store, synpanel, gwas_input, annot_file_g):
    path, _ = gwas_input
    pop_wgt = {"AAA": 0.4, "BBB": 0.35, "EEE": 0.25}
    host = gauss_jax.jepegmix(
        pd.DataFrame({"pop": list(pop_wgt), "wgt": list(pop_wgt.values())}),
        path, annot_file_g, synpanel.files.index_file,
        synpanel.files.data_file, synpanel.files.pop_desc_file)
    eng = GenomeEngine(store)
    inp = readers.read_input_z(path, all_snps=True)
    annot = readers.read_annotation(annot_file_g)
    pg = eng.prepare_genes(inp, annot, pop_wgt=pop_wgt)
    res = pg.jepeg_region()
    host, res = _gene_sorted(host), _gene_sorted(res)
    assert list(host["geneid"]) == list(res["geneid"])
    np.testing.assert_allclose(res["chisq"], host["chisq"],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(res["df"], host["df"])

    # chunk partition: genes assigned by first-SNP bp; two disjoint
    # ranges must union to the full gene set with identical rows
    bps = synpanel.index_df["bp"]
    mid = int((bps.min() + bps.max()) // 2)
    a = pg.jepeg_region(int(bps.min()), mid)
    b = pg.jepeg_region(mid + 1, int(bps.max()))
    both = _gene_sorted(pd.concat([a, b], ignore_index=True))
    assert list(both["geneid"]) == list(res["geneid"])
    np.testing.assert_allclose(both["chisq"], res["chisq"],
                               rtol=1e-12, atol=0)


def test_engine_jepeg_on_mesh_matches_single_device(
        store, synpanel, gwas_input, annot_file_g):
    """jepeg_region over a (2 x 4) mesh (genes data-parallel on the
    window axis, subjects sharded + psum'd) == 1-device result.  The
    psum'd partial statistics are exact integer sums, so the match is
    to f64 determinism, not a loose tolerance."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from gauss_jax.parallel.mesh import make_mesh
    path, _ = gwas_input
    inp = readers.read_input_z(path, all_snps=True)
    annot = readers.read_annotation(annot_file_g)
    pop_wgt = {"AAA": 0.4, "BBB": 0.35, "EEE": 0.25}

    res_1 = GenomeEngine(store).prepare_genes(
        inp, annot, pop_wgt=pop_wgt).jepeg_region()
    res_m = GenomeEngine(store, mesh=make_mesh(2, 4)).prepare_genes(
        inp, annot, pop_wgt=pop_wgt).jepeg_region()
    res_1, res_m = _gene_sorted(res_1), _gene_sorted(res_m)
    assert list(res_1["geneid"]) == list(res_m["geneid"])
    np.testing.assert_allclose(res_m["chisq"], res_1["chisq"],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(res_m["df"], res_1["df"])
    assert list(res_m["top_categ"]) == list(res_1["top_categ"])

    # homogeneous (jepeg) mode over the mesh as well
    h_1 = GenomeEngine(store).prepare_genes(
        inp, annot, study_pop="EUR").jepeg_region()
    h_m = GenomeEngine(store, mesh=make_mesh(2, 4)).prepare_genes(
        inp, annot, study_pop="EUR").jepeg_region()
    h_1, h_m = _gene_sorted(h_1), _gene_sorted(h_m)
    np.testing.assert_allclose(h_m["chisq"], h_1["chisq"],
                               rtol=1e-12, atol=1e-12)


def test_ld_i16tri_fetch_bound(store, synpanel, gwas_input):
    """The packed int16-triangle LD fetch must match the full-f32 fetch
    within the documented quantization bound LD_I16_MAX_ERR, with an
    exactly-1.0 diagonal and exact symmetry."""
    from gauss_jax.io import readers
    from gauss_jax.ops.window_kernel import LD_I16_MAX_ERR

    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=0)
    pop_wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    run = GenomeEngine(store, snp_bucket=64, device_linalg=True
                       ).prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    a = run.ld_window(lo, hi, fetch="i16tri")
    b = run.ld_window(lo, hi, fetch="f32")
    assert a["cormat"].shape == b["cormat"].shape
    d = np.abs(a["cormat"] - b["cormat"]).max()
    assert d <= LD_I16_MAX_ERR + 1e-12, d
    np.testing.assert_array_equal(np.diag(a["cormat"]), 1.0)
    np.testing.assert_array_equal(a["cormat"], a["cormat"].T)

    ra = run.ld_region(lo, hi, window_bp=(hi - lo) // 2)
    rb = run.ld_region(lo, hi, window_bp=(hi - lo) // 2, fetch="f32")
    assert len(ra) == len(rb) > 0
    for x, y in zip(ra, rb):
        assert np.abs(x["cormat"] - y["cormat"]).max() <= LD_I16_MAX_ERR + 1e-12


def test_resident_region_matches_gather_region(store, synpanel, gwas_input):
    """The gather-free resident region kernel (bp-sorted panels +
    band-offset streaming) must reproduce the gather-based region
    scan.  Forced on for CPU via region_mode='resident' (its Gram is
    the XLA form there)."""
    from gauss_jax.io import readers

    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=(hi - lo) // 3)
    pop_wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    kw = dict(window_bp=(hi - lo) // 3 + 1, wing_size=(hi - lo) // 3)

    run_r = GenomeEngine(store, snp_bucket=64, device_linalg=True,
                         region_mode="resident").prepare_mix(
        inp, pop_wgt, af1_cutoff=0.01)
    df_r = run_r.impute_region(lo, hi, **kw)

    run_g = GenomeEngine(store, snp_bucket=64, device_linalg=True,
                         region_mode="gather").prepare_mix(
        inp, pop_wgt, af1_cutoff=0.01)
    df_g = run_g.impute_region(lo, hi, **kw)

    assert len(df_r) == len(df_g) > 0
    assert (df_r["rsid"].to_numpy() == df_g["rsid"].to_numpy()).all()
    imp = df_g["type"].to_numpy() == 0
    assert imp.sum() > 0
    # both sides are f32 device solves but with different algorithms
    # (resident: blocked-matmul trsm at 256-aligned shapes; gather:
    # XLA TriangularSolve at the 64-bucket shapes), so agreement is
    # f32-solve-noise scale, not bitwise
    np.testing.assert_allclose(df_r["z"].to_numpy()[imp],
                               df_g["z"].to_numpy()[imp],
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(df_r["info"].to_numpy()[imp],
                               df_g["info"].to_numpy()[imp],
                               rtol=2e-4, atol=2e-5)
    # the async handle replays the same cached batch
    df_a = run_r.impute_region_async(lo, hi, **kw).result()
    np.testing.assert_array_equal(df_a["z"].to_numpy(),
                                  df_r["z"].to_numpy())
    assert len(run_r._region_batch(lo, hi, **kw)[0]) >= 2


def test_resident_qcat_matches_gather_qcat(store, synpanel, gwas_input):
    """Resident-streamed qcat_region == gather-based qcat_region."""
    from gauss_jax.io import readers

    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=(hi - lo) // 3)
    pop_wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    kw = dict(window_bp=(hi - lo) // 3 + 1, wing_size=(hi - lo) // 3)

    q_r = GenomeEngine(store, snp_bucket=64, device_linalg=True,
                       region_mode="resident").prepare_mix(
        inp, pop_wgt, af1_cutoff=0.05).qcat_region(lo, hi, **kw)
    q_g = GenomeEngine(store, snp_bucket=64, device_linalg=True,
                       region_mode="gather").prepare_mix(
        inp, pop_wgt, af1_cutoff=0.05).qcat_region(lo, hi, **kw)
    assert len(q_r) == len(q_g) > 0
    assert (q_r["qcat_m"].to_numpy() == q_g["qcat_m"].to_numpy()).all()
    np.testing.assert_allclose(q_r["qcat_t"].to_numpy(),
                               q_g["qcat_t"].to_numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(q_r["qcat_chisq"].to_numpy(),
                               q_g["qcat_chisq"].to_numpy(),
                               rtol=2e-4, atol=2e-5)


def test_resident_pooled_matches_gather(store, synpanel, gwas_input):
    """Pooled (homogeneous dist / qcat, wgts=None) resident kernels ==
    the gather-based region paths.  'EUR' is a super-pop spanning two
    panel segments (AAA+BBB), so the single pooled accumulation group
    must also span the K_TILE zero padding between segments."""
    from gauss_jax.io import readers

    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=(hi - lo) // 3)
    kw = dict(window_bp=(hi - lo) // 3 + 1, wing_size=(hi - lo) // 3)

    dfs = {}
    for mode in ("resident", "gather"):
        dfs[mode] = GenomeEngine(store, snp_bucket=64, device_linalg=True,
                                 region_mode=mode).prepare_homog(
            inp, "EUR", af1_cutoff=0.01).impute_region(lo, hi, **kw)
    df_r, df_g = dfs["resident"], dfs["gather"]
    assert len(df_r) == len(df_g) > 0
    assert (df_r["rsid"].to_numpy() == df_g["rsid"].to_numpy()).all()
    imp = df_g["type"].to_numpy() == 0
    assert imp.sum() > 0
    # both sides are f32 device solves but with different algorithms
    # (resident: blocked-matmul trsm at 256-aligned shapes; gather:
    # XLA TriangularSolve at the 64-bucket shapes), so agreement is
    # f32-solve-noise scale, not bitwise
    np.testing.assert_allclose(df_r["z"].to_numpy()[imp],
                               df_g["z"].to_numpy()[imp],
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(df_r["info"].to_numpy()[imp],
                               df_g["info"].to_numpy()[imp],
                               rtol=2e-4, atol=2e-5)

    # pooled qcat (the reference qcat default af1_cutoff is 0.05)
    qs = {}
    for mode in ("resident", "gather"):
        qs[mode] = GenomeEngine(store, snp_bucket=64, device_linalg=True,
                                region_mode=mode).prepare_homog(
            inp, "EUR", af1_cutoff=0.05).qcat_region(lo, hi, **kw)
    assert len(qs["resident"]) == len(qs["gather"]) > 0
    assert (qs["resident"]["qcat_m"].to_numpy()
            == qs["gather"]["qcat_m"].to_numpy()).all()
    np.testing.assert_allclose(qs["resident"]["qcat_t"].to_numpy(),
                               qs["gather"]["qcat_t"].to_numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(qs["resident"]["qcat_chisq"].to_numpy(),
                               qs["gather"]["qcat_chisq"].to_numpy(),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("cfg", [
    # (window divisor, wing divisor, start offset, end offset)
    (5, 8, 0, 0),          # many small windows, some below min counts
    (2, 2, 997, -1_003),   # offset region, big wings
    (1, 6, 12_345, 0),     # single window, asymmetric clipping
])
def test_resident_region_boundary_fuzz(store, synpanel, gwas_input, cfg):
    """Resident == gather across window tilings that exercise the
    band-offset edges: first/last windows, clipped regions, windows
    skipped by the reference min-count rule."""
    from gauss_jax.io import readers
    wd, gd, so, eo = cfg
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()) + so, int(bp.max()) + eo
    span = hi - lo
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=span // gd)
    pop_wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    kw = dict(window_bp=span // wd + 1, wing_size=span // gd)

    dfs = {}
    for mode in ("resident", "gather"):
        run = GenomeEngine(store, snp_bucket=64, device_linalg=True,
                           region_mode=mode).prepare_mix(
            inp, pop_wgt, af1_cutoff=0.01)
        dfs[mode] = run.impute_region(lo, hi, **kw)
    a, b = dfs["resident"], dfs["gather"]
    assert len(a) == len(b)
    if len(a) == 0:
        return
    assert (a["rsid"].to_numpy() == b["rsid"].to_numpy()).all()
    imp = b["type"].to_numpy() == 0
    np.testing.assert_allclose(a["z"].to_numpy()[imp],
                               b["z"].to_numpy()[imp],
                               rtol=2e-4, atol=2e-5)


def test_resident_ld_region_matches_gather(store, synpanel, gwas_input):
    """One-dispatch resident LD region (build_resident_ld_kernel,
    band-streamed mm Gram, computeLD semantics src/computeLD.cpp:104-116)
    vs the gather-based per-window LD kernels, both fetch modes."""
    from gauss_jax.io import readers
    from gauss_jax.ops.window_kernel import LD_I16_MAX_ERR

    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=0)
    pop_wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    run_g = GenomeEngine(store, snp_bucket=64, device_linalg=True
                         ).prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    run_r = GenomeEngine(store, snp_bucket=64, device_linalg=True,
                         region_mode="resident"
                         ).prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    wbp = (hi - lo) // 3
    for fetch, tol in (("f32", 5e-5), ("i16tri", 2 * LD_I16_MAX_ERR)):
        a = run_g.ld_region(lo, hi, window_bp=wbp, fetch=fetch)
        b = run_r.ld_region(lo, hi, window_bp=wbp, fetch=fetch)
        assert len(a) == len(b) > 1
        for x, y in zip(a, b):
            assert list(x["snplist"]["rsid"]) == list(y["snplist"]["rsid"])
            assert x["cormat"].shape == y["cormat"].shape
            np.testing.assert_array_equal(np.diag(y["cormat"]), 1.0)
            d = np.abs(x["cormat"] - y["cormat"]).max()
            assert d <= tol, (fetch, d)


def test_aligned_fallback_matches(store, synpanel, gwas_input, monkeypatch):
    """Very long regions fall back from the per-window aligned resident
    layout to the shared bp-sorted layout (GAUSS_ALIGNED_MAX_BYTES cap);
    both must impute identically up to f32 solve noise."""
    from gauss_jax.io import readers
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    wing = (hi - lo) // 6
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=wing)
    pop_wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    kw = dict(window_bp=(hi - lo) // 3 + 1, wing_size=wing)

    def run_once():
        eng = GenomeEngine(store, snp_bucket=64, device_linalg=True,
                           region_mode="resident")
        return eng.prepare_mix(inp, pop_wgt).impute_region(lo, hi, **kw)

    df_a = run_once()
    monkeypatch.setenv("GAUSS_ALIGNED_MAX_BYTES", "1")
    df_s = run_once()
    assert len(df_a) == len(df_s) > 0
    imp = df_a["type"].to_numpy() == 0
    assert imp.sum() > 0
    np.testing.assert_allclose(df_a["z"].to_numpy()[imp],
                               df_s["z"].to_numpy()[imp],
                               rtol=2e-4, atol=1e-4)


def test_impute_regions_pipelined_matches_sequential(store, synpanel,
                                                     gwas_input):
    """The pipelined region generator (impute_regions, depth 2) yields
    exactly what sequential impute_region calls produce, in span
    order."""
    from gauss_jax.io import readers
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    mid = (lo + hi) // 2
    wing = (hi - lo) // 6
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=wing)
    pop_wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    eng = GenomeEngine(store, snp_bucket=64, device_linalg=True)
    run = eng.prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    spans = [(lo, mid), (mid + 1, hi)]
    kw = dict(window_bp=(hi - lo) // 4 + 1, wing_size=wing)
    piped = list(run.impute_regions(spans, **kw))
    assert [(a, b) for a, b, _ in piped] == spans
    for (s0, s1), (_, _, df) in zip(spans, piped):
        ref = run.impute_region(s0, s1, **kw)
        assert df.equals(ref), (s0, s1)


def test_aligned_batch_cache_evicts_older_spans(store, synpanel,
                                                gwas_input):
    """Aligned-layout batches carry dedicated device panels; only the
    newest span's batch may stay cached (HBM leak guard), while
    repeated calls on one span still hit the cache."""
    from gauss_jax.io import readers
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    mid = (lo + hi) // 2
    wing = (hi - lo) // 6
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=wing)
    pop_wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    eng = GenomeEngine(store, snp_bucket=64, device_linalg=True,
                       region_mode="resident")
    run = eng.prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    kw = dict(window_bp=(hi - lo) // 4 + 1, wing_size=wing)
    run.impute_region(lo, mid, **kw)
    b1 = run._res.get(("batch", (lo, mid) + tuple(kw.values())))
    assert b1 is not None and len(b1[1]) == 7     # aligned batch cached
    run.impute_region(mid + 1, hi, **kw)
    # older span evicted, newest kept
    assert ("batch", (lo, mid) + tuple(kw.values())) not in run._res
    b2key = ("batch", (mid + 1, hi) + tuple(kw.values()))
    b2 = run._res.get(b2key)
    assert b2 is not None
    # same-span repeat still hits the cache (same object, no rebuild)
    run.impute_region(mid + 1, hi, **kw)
    assert run._res.get(b2key) is b2
