"""Parity tests against the reference repo's bundled data fixtures.

These run whenever a mirror of statsleelab/gauss is available (env
GAUSS_REFERENCE_DIR, default /root/reference) and exercise our readers
and pure-math kernels on the reference's own shipped inputs
(data/PGC2_*.txt -- SURVEY.md section 4.3).  Full-pipeline goldens
need the 33KG panel; see test_goldens_33kg.py.
"""

import os

import numpy as np
import pytest

import gauss_jax
from gauss_jax.io import readers
from gauss_jax.utils import goldens

REF = goldens.reference_dir()
pytestmark = pytest.mark.skipif(REF is None,
                                reason="reference mirror not available")


def test_read_pgc2_chr22_z():
    """13,362 input lines of `rsid chr bp a1 a2 z`; 4 duplicate
    (chr,bp,a1,a2) keys collapse keep-last per the reference's
    `snp_map[mkey] = snp` overwrite (src/gauss.cpp:182)."""
    df = readers.read_input_z(os.path.join(REF, goldens.PGC2_CHR22_Z),
                              all_snps=True)
    assert len(df) == 13358
    assert (df["chr"] == 22).all()
    row = df[df["rsid"] == "rs1000427"].iloc[0]
    assert row["bp"] == 36890105 and row["a1"] == "A" and row["a2"] == "G"
    assert np.isclose(row["z"], -1.49697409010693)


def test_read_pgc2_chr22_af():
    df = readers.read_input_af(os.path.join(REF, goldens.PGC2_CHR22_AF))
    assert len(df) == 13358
    assert ((df["af1study"] >= 0) & (df["af1study"] <= 1)).all()


def test_read_pgc2_3mb_window_filter():
    """721 SNPs; window filter matches ReadInputZ semantics
    (src/gauss.cpp:155-163)."""
    path = os.path.join(REF, goldens.PGC2_3MB)
    df = readers.read_input_z(path, all_snps=True)
    assert len(df) == 721
    win = readers.read_input_z(path, chrom=10, start_bp=104_000_001,
                               end_bp=105_000_000, wing_size=500_000)
    bp = win["bp"].to_numpy()
    assert (bp >= 103_500_001).all() and (bp <= 105_500_000).all()
    assert 0 < len(win) < 721


def test_fiqt_on_real_pgc2_z():
    """FIQT invariants on the real PGC2 chr22 Z-scores: adjusted |z|
    never exceeds raw |z|, signs preserved, extreme z passed through
    (R/fiqt.R:7-14)."""
    df = readers.read_input_z(os.path.join(REF, goldens.PGC2_CHR22_Z),
                              all_snps=True)
    z = df["z"].to_numpy()
    z_adj = np.asarray(gauss_jax.fiqt(z))
    assert z_adj.shape == z.shape
    assert np.all(np.abs(z_adj) <= np.abs(z) + 1e-12)
    # sign preserved except where BH-adjusted p hits 1 -> z_adj == 0
    nz = (z != 0) & (z_adj != 0)
    assert np.all(np.sign(z_adj[nz]) == np.sign(z[nz]))


def test_bundled_anc_prop_matches_afmix_golden():
    """Our bundled PGC2_SCZ_ANC_Prop equals the published afmix result
    table (docs/articles/afmix_example.md)."""
    df = gauss_jax.PGC2_SCZ_ANC_Prop
    assert len(df) == 21
    got = dict(zip(df["pop"], df["wgt"]))
    assert got == goldens.AFMIX_GOLD
    # weights are raw per-subset OLS averages, clamped >= 0 and rounded
    # to 3 decimals WITHOUT renormalization (src/afmix.cpp:195-202);
    # the published table sums to 1.061
    assert 0.9 < df["wgt"].sum() < 1.2
