"""Panel write/read roundtrip and index parsing."""

import numpy as np

from gauss_jax.io.panel import PanelReader, read_panel_index


def test_index_roundtrip(synpanel):
    idx = read_panel_index(synpanel.files.index_file)
    assert len(idx) == len(synpanel.index_df)
    assert (idx["rsid"] == synpanel.index_df["rsid"]).all()
    assert (idx["bp"] == synpanel.index_df["bp"]).all()


def test_index_window_filter(synpanel):
    full = read_panel_index(synpanel.files.index_file)
    lo, hi = int(full["bp"].iloc[50]), int(full["bp"].iloc[100])
    idx = read_panel_index(synpanel.files.index_file, chrom=22,
                           start_bp=lo, end_bp=hi, wing_size=0)
    assert idx["bp"].min() >= lo and idx["bp"].max() <= hi
    assert len(idx) == 51


def test_decode_all_pops(synpanel):
    idx = read_panel_index(synpanel.files.index_file)
    reader = PanelReader(synpanel.files.data_file, synpanel.desc)
    dec = reader.decode_rows(idx["fpos"].to_numpy())
    assert dec.G.shape == synpanel.genotypes.shape
    np.testing.assert_array_equal(dec.G, synpanel.genotypes)
    np.testing.assert_allclose(dec.af, synpanel.afs, atol=5e-7)


def test_decode_selected_pops_and_order(synpanel):
    idx = read_panel_index(synpanel.files.index_file)
    reader = PanelReader(synpanel.files.data_file, synpanel.desc)
    flags = np.array([0, 1, 0, 1, 0], dtype=np.int8)
    # shuffled row order must be preserved in the output
    rng = np.random.default_rng(3)
    rows = rng.permutation(len(idx))[:40]
    dec = reader.decode_rows(idx["fpos"].to_numpy()[rows], pop_flags=flags)
    b = np.concatenate([[0], np.cumsum(synpanel.desc.sizes)])
    expected = np.concatenate(
        [synpanel.genotypes[rows][:, b[1]:b[2]],
         synpanel.genotypes[rows][:, b[3]:b[4]]], axis=1)
    np.testing.assert_array_equal(dec.G, expected)
    assert list(dec.pop_index) == [1, 3]


def test_pop_wgt_unknown_names_ignored_with_warning(synpanel):
    """Reference silently ignores weight names absent from the panel
    (src/gauss.cpp:1093-1117 has no unknown-name branch); we warn by
    default and raise only with strict=True."""
    import numpy as np
    import pytest
    from gauss_jax.io import readers
    desc = synpanel.desc
    wmap = {desc.pops[0]: 0.6, desc.pops[1]: 0.4, "NOSUCHPOP": 0.1}
    with pytest.warns(RuntimeWarning, match="NOSUCHPOP"):
        flags, wgts = readers.init_pop_flag_wgts(desc, wmap)
    assert flags.sum() == 2
    np.testing.assert_allclose(wgts, [0.6, 0.4])
    with pytest.raises(ValueError, match="NOSUCHPOP"):
        readers.init_pop_flag_wgts(desc, wmap, strict=True)
    with pytest.raises(ValueError, match="selects no panel"):
        readers.init_pop_flag_wgts(desc, {"NOSUCHPOP": 1.0})


def test_annotation_unknown_category_skipped(tmp_path):
    """Unknown annotation categories are dropped with a warning instead
    of reproducing the reference's keep-previous-categ uninitialized
    read (src/gauss.cpp:1319-1330) or crashing downstream."""
    import pytest
    from gauss_jax.io import readers
    path = tmp_path / "annot.txt"
    path.write_text(
        "rsid chr bp a1 a2 geneid categ wgt\n"
        "rs1 22 100 A C GENE1 PROTEIN 1.0\n"
        "rs2 22 200 A C GENE1 MADE_UP 0.5\n"
        "rs3 22 300 A C GENE2 CIS_EQTL 0.8\n")
    with pytest.warns(RuntimeWarning, match="MADE_UP"):
        df = readers.read_annotation(str(path))
    assert list(df["rsid"]) == ["rs1", "rs3"]
    assert list(df["categ_num"]) == [0, 4]
