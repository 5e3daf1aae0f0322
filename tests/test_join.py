"""Allele-aware join semantics (the parity-critical layer)."""

import numpy as np
import pandas as pd
import pytest

from gauss_jax.core.variants import (DuplicateInputError,
                                     join_reference_index, sort_map_order)


def _inp(rows):
    df = pd.DataFrame(rows, columns=["rsid", "chr", "bp", "a1", "a2", "z"])
    df["info"] = 1.0
    df["type"] = np.int8(2)
    return df


def _idx(rows):
    return pd.DataFrame(rows, columns=["rsid", "chr", "bp", "a1", "a2",
                                       "af1ref", "fpos"])


def test_exact_swap_unmeasured_and_type2():
    inp = _inp([
        ("in1", 1, 100, "A", "G", 1.5),    # exact match
        ("in2", 1, 200, "G", "A", -2.0),   # swapped in panel (A,G)
        ("in3", 1, 400, "C", "T", 0.7),    # not in panel -> type 2
    ])
    idx = _idx([
        ("ref1", 1, 100, "A", "G", 0.2, 11),
        ("ref2", 1, 200, "A", "G", 0.3, 22),
        ("ref4", 1, 300, "T", "C", 0.4, 33),  # not in input -> type 0
    ])
    out = join_reference_index(inp, idx, add_unmeasured=True)
    assert len(out) == 4
    r100 = out[out.bp == 100].iloc[0]
    assert r100.rsid == "ref1" and r100.type == 1 and r100.fpos == 11
    assert r100.z == 1.5
    r200 = out[out.bp == 200].iloc[0]
    assert (r200.a1, r200.a2) == ("A", "G")  # adopted panel order
    assert r200.z == 2.0                      # flipped sign
    assert r200.type == 1 and r200.fpos == 22
    r300 = out[out.bp == 300].iloc[0]
    assert r300.type == 0 and r300.z == 0.0 and r300.rsid == "ref4"
    r400 = out[out.bp == 400].iloc[0]
    assert r400.type == 2 and r400.fpos == -1


def test_duplicate_orientations_error():
    inp = _inp([
        ("in1", 1, 100, "A", "G", 1.0),
        ("in2", 1, 100, "G", "A", 2.0),
    ])
    idx = _idx([("ref1", 1, 100, "A", "G", 0.2, 11)])
    with pytest.raises(DuplicateInputError):
        join_reference_index(inp, idx, add_unmeasured=True)


def test_all_variant_flips_af1study():
    inp = _inp([("in1", 1, 200, "G", "A", -2.0)])
    inp["af1study"] = 0.25
    out = join_reference_index(
        inp, _idx([("ref", 1, 200, "A", "G", 0.3, 5)]),
        add_unmeasured=False, flip_af1study=True)
    assert out.iloc[0].af1study == 0.75
    assert out.iloc[0].z == 2.0
    # windowed variant does NOT flip af1study
    out2 = join_reference_index(
        inp, _idx([("ref", 1, 200, "A", "G", 0.3, 5)]),
        add_unmeasured=True, flip_af1study=False)
    assert out2.iloc[0].af1study == 0.25


def test_no_unmeasured_added_in_all_mode():
    inp = _inp([("in1", 1, 100, "A", "G", 1.0)])
    idx = _idx([
        ("ref1", 1, 100, "A", "G", 0.2, 11),
        ("ref2", 1, 300, "T", "C", 0.4, 33),
    ])
    out = join_reference_index(inp, idx, add_unmeasured=False)
    assert len(out) == 1


def test_map_key_order():
    # MapKey orders by chr, bp, then allele strings bytewise
    df = pd.DataFrame({
        "chr": [2, 1, 1, 1, 1],
        "bp": [5, 10, 10, 10, 2],
        "a1": ["A", "T", "AT", "A", "G"],
        "a2": ["C", "G", "C", "C", "T"],
    })
    out = sort_map_order(df)
    keys = list(zip(out.chr, out.bp, out.a1, out.a2))
    assert keys == [(1, 2, "G", "T"), (1, 10, "A", "C"), (1, 10, "AT", "C"),
                    (1, 10, "T", "G"), (2, 5, "A", "C")]
