"""Full-pipeline golden parity vs the reference's published outputs.

Requires the real 33KG panel (29 pops, 32,953 subjects), which is
distributed out-of-band (vignettes/ref_33KG.Rmd:17-21) and is NOT in
this environment.  Point GAUSS_33KG_DIR at a directory containing
33kg_index.gz / 33kg_geno.gz / 33kg_pop_desc.txt and these tests
reproduce the executed-vignette numbers (docs/articles/*.md) that are
the reference's only regression oracles (SURVEY.md section 4):

* dist() head rows  (z, info, af1ref)      -- dist_example.md
* distmix() head rows (z, info, af1mix)    -- dist_example.md
* computeLD() snplist + cormat corner      -- computeLD_example.md
* afmix() weights == PGC2_SCZ_ANC_Prop     -- afmix_example.md

Tolerance: the reference computes in float64 scalar loops; our host
parity path is float64 with exact f32 sufficient statistics, so z/info
agree to ~1e-6; AFs are deterministic rounding (ceil 1e5) and match
exactly.
"""

import os

import numpy as np
import pytest

import gauss_jax
from gauss_jax.utils import goldens

PANEL = goldens.panel_dir()
REF = goldens.reference_dir()
pytestmark = pytest.mark.skipif(
    PANEL is None or REF is None,
    reason="33KG panel not available (set GAUSS_33KG_DIR)")


def _panel_files():
    return dict(
        reference_index_file=os.path.join(PANEL, "33kg_index.gz"),
        reference_data_file=os.path.join(PANEL, "33kg_geno.gz"),
        reference_pop_desc_file=os.path.join(PANEL, "33kg_pop_desc.txt"),
    )


def _check_rows(res, gold, af_col):
    res = res[res["type"] == 0].reset_index(drop=True)
    for i, (rsid, af, z, info) in enumerate(gold):
        row = res.iloc[i]
        assert row["rsid"] == rsid
        np.testing.assert_allclose(row[af_col], af, atol=5e-7)
        np.testing.assert_allclose(row["z"], z, atol=5e-5)
        np.testing.assert_allclose(row["info"], info, atol=5e-5)


def test_dist_golden_head():
    res = gauss_jax.dist(
        goldens.DIST_CALL["chrom"], goldens.DIST_CALL["start_bp"],
        goldens.DIST_CALL["end_bp"], goldens.DIST_CALL["wing_size"],
        goldens.DIST_CALL["study_pop"],
        os.path.join(REF, goldens.PGC2_3MB), **_panel_files())
    _check_rows(res, goldens.DIST_GOLD, "af1ref")


def test_distmix_golden_head():
    res = gauss_jax.distmix(
        goldens.DISTMIX_CALL["chrom"], goldens.DISTMIX_CALL["start_bp"],
        goldens.DISTMIX_CALL["end_bp"], goldens.DISTMIX_CALL["wing_size"],
        gauss_jax.PGC2_SCZ_ANC_Prop,
        os.path.join(REF, goldens.PGC2_3MB), **_panel_files())
    _check_rows(res, goldens.DISTMIX_GOLD, "af1mix")


def test_computeld_golden_corner():
    res = gauss_jax.compute_ld(
        goldens.COMPUTELD_CALL["chrom"], goldens.COMPUTELD_CALL["start_bp"],
        goldens.COMPUTELD_CALL["end_bp"], gauss_jax.PGC2_SCZ_ANC_Prop,
        os.path.join(REF, goldens.PGC2_3MB), **_panel_files(),
        af1_cutoff=goldens.COMPUTELD_CALL["af1_cutoff"])
    snplist, cormat = res["snplist"], res["cormat"]
    for i, (rsid, af) in enumerate(goldens.COMPUTELD_SNPLIST_GOLD):
        assert snplist.iloc[i]["rsid"] == rsid
        np.testing.assert_allclose(snplist.iloc[i]["af1mix"], af, atol=5e-7)
    np.testing.assert_allclose(
        np.asarray(cormat)[:3, :3], goldens.COMPUTELD_CORMAT_GOLD, atol=5e-6)


def test_afmix_golden_weights():
    res = gauss_jax.afmix(
        os.path.join(REF, goldens.PGC2_CHR22_AF), **_panel_files())
    got = dict(zip(res["pop"], res["wgt"]))
    for pop, wgt in goldens.AFMIX_GOLD.items():
        # weights are rounded to 3 decimals (src/afmix.cpp:195-202)
        assert pop in got, f"population {pop} missing from afmix output"
        np.testing.assert_allclose(got[pop], wgt, atol=1.5e-3)


ANNOT = "data/JEPEG_SNP_Annotation.v1.0.txt"


def _check_genes(res, gold):
    """Top rows of the pval-sorted gene frame vs the executed-vignette
    table (docs/articles/jepeg_example.md); chisq to 5e-5, identity
    columns exact."""
    res = res.sort_values("jepeg_pval").reset_index(drop=True)
    got = res.set_index("geneid")
    for geneid, chisq, df, top_categ, top_snp in gold:
        assert geneid in got.index, f"gene {geneid} missing"
        row = got.loc[geneid]
        np.testing.assert_allclose(row["chisq"], chisq, atol=5e-5)
        assert int(row["df"]) == df
        assert row["top_categ"] == top_categ
        assert row["top_snp"] == top_snp
    # and the golden genes are the top of the ranking
    top = list(res["geneid"].iloc[:len(gold)])
    assert set(g[0] for g in gold) <= set(res["geneid"].iloc[:10])


def _annotation_path():
    p = os.path.join(REF, ANNOT) if REF else None
    if p is None or not os.path.isfile(p):
        pytest.skip("JEPEG annotation file not available "
                    "(.MISSING_LARGE_BLOBS in the reference mirror)")
    return p


def test_jepeg_golden():
    res = gauss_jax.jepeg(
        "GBR", os.path.join(REF, goldens.PGC2_CHR22_Z),
        _annotation_path(), **_panel_files())
    _check_genes(res, goldens.JEPEG_GOLD)


def test_jepegmix_golden():
    res = gauss_jax.jepegmix(
        gauss_jax.PGC2_SCZ_ANC_Prop,
        os.path.join(REF, goldens.PGC2_CHR22_Z),
        _annotation_path(), **_panel_files())
    _check_genes(res, goldens.JEPEGMIX_GOLD)
