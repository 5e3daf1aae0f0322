"""CLI smoke tests."""

import numpy as np
import pandas as pd
import pytest

from gauss_jax import cli


@pytest.fixture(scope="module")
def region(synpanel):
    bp = synpanel.index_df["bp"]
    return int(bp.min()), int(bp.max())


def _ref_argv(synpanel):
    return ["--reference-index-file", synpanel.files.index_file,
            "--reference-data-file", synpanel.files.data_file,
            "--reference-pop-desc-file", synpanel.files.pop_desc_file]


def test_cli_distmix(synpanel, gwas_input, region, tmp_path):
    path, _ = gwas_input
    lo, hi = region
    wgt_file = tmp_path / "wgt.tsv"
    pd.DataFrame({"pop": ["AAA", "CCC"], "wgt": [0.6, 0.4]}).to_csv(
        wgt_file, sep="\t", index=False)
    out = tmp_path / "out.tsv"
    cli.main(["distmix", "--chr", "22",
              "--start-bp", str(lo + (hi - lo) // 3),
              "--end-bp", str(lo + 2 * (hi - lo) // 3),
              "--wing-size", str(hi - lo),
              "--pop-wgt-file", str(wgt_file),
              "--input-file", path] + _ref_argv(synpanel)
             + ["-o", str(out)])
    df = pd.read_csv(out, sep="\t")
    assert {"rsid", "z", "pval", "info", "type"} <= set(df.columns)
    assert len(df) > 0


def test_cli_compute_ld(synpanel, gwas_input, region, tmp_path):
    path, _ = gwas_input
    lo, hi = region
    wgt_file = tmp_path / "wgt.tsv"
    pd.DataFrame({"pop": ["AAA", "EEE"], "wgt": [0.7, 0.3]}).to_csv(
        wgt_file, sep="\t", index=False)
    out = tmp_path / "snplist.tsv"
    cormat = tmp_path / "cormat.tsv"
    cli.main(["computeLD", "--chr", "22", "--start-bp", str(lo),
              "--end-bp", str(hi), "--pop-wgt-file", str(wgt_file),
              "--input-file", path] + _ref_argv(synpanel)
             + ["-o", str(out), "--cormat-out", str(cormat)])
    snplist = pd.read_csv(out, sep="\t")
    mat = np.loadtxt(cormat)
    assert mat.shape == (len(snplist), len(snplist))


def test_cli_fiqt(tmp_path):
    zfile = tmp_path / "z.txt"
    pd.DataFrame({"z": [0.5, -3.2, 7.7]}).to_csv(zfile, sep="\t", index=False)
    out = tmp_path / "o.tsv"
    cli.main(["fiqt", "--input-file", str(zfile), "-o", str(out)])
    df = pd.read_csv(out, sep="\t")
    assert "z_fiqt" in df.columns


def test_cli_impute_genome_and_status(synpanel, gwas_input, region,
                                      tmp_path, capsys):
    import json
    import os
    path, _ = gwas_input
    lo, hi = region
    wgt_file = tmp_path / "wgt.tsv"
    pd.DataFrame({"pop": ["AAA", "BBB"], "wgt": [0.5, 0.5]}).to_csv(
        wgt_file, sep="\t", index=False)
    run_dir = tmp_path / "run"
    out = tmp_path / "genome.tsv"
    base = ["impute-genome", "--chr", "22", "--start-bp", str(lo),
            "--end-bp", str(hi), "--pop-wgt-file", str(wgt_file),
            "--input-file", path,
            "--window-bp", str((hi - lo) // 2 + 1),
            "--wing-size", str(hi - lo),
            "--chunk-bp", str(hi - lo + 1),
            "--run-dir", str(run_dir)] + _ref_argv(synpanel)
    cli.main(base + ["-o", str(out)])
    df = pd.read_csv(out, sep="\t")
    assert len(df) > 0

    # --status must be read-only: manifest untouched, chunk ledger printed
    mpath = run_dir / "manifest.json"
    before = mpath.read_text()
    capsys.readouterr()
    cli.main(base + ["--status", "-o", str(tmp_path / "ignored.tsv")])
    cap = capsys.readouterr()
    counts = json.loads(cap.out.strip().splitlines()[-1])
    assert counts["done"] >= 1 and counts["failed"] == 0
    assert mpath.read_text() == before
    assert not os.path.exists(tmp_path / "ignored.tsv")


def test_cli_impute_region_mesh(synpanel, gwas_input, region, tmp_path):
    """--mesh 2x4 output == unsharded --device-linalg output."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    import numpy as np
    path, _ = gwas_input
    lo, hi = region
    wgt_file = tmp_path / "wgt.tsv"
    pops = synpanel.desc.pops
    pd.DataFrame({"pop": pops, "wgt": [1.0 / len(pops)] * len(pops)}).to_csv(
        wgt_file, sep="\t", index=False)
    base = ["impute-region", "--chr", "22", "--start-bp", str(lo),
            "--end-bp", str(hi), "--pop-wgt-file", str(wgt_file),
            "--input-file", path, "--window-bp", str((hi - lo) // 3 + 1),
            "--wing-size", str((hi - lo) // 3)] + _ref_argv(synpanel)
    out_m = tmp_path / "mesh.tsv"
    out_1 = tmp_path / "one.tsv"
    cli.main(base + ["--mesh", "2x4", "-o", str(out_m)])
    cli.main(base + ["--device-linalg", "-o", str(out_1)])
    df_m = pd.read_csv(out_m, sep="\t")
    df_1 = pd.read_csv(out_1, sep="\t")
    assert len(df_m) == len(df_1) > 0
    np.testing.assert_allclose(df_m["z"].to_numpy(), df_1["z"].to_numpy(),
                               rtol=2e-5, atol=2e-5)


def test_cli_zmix_mesh(synpanel, gwas_input, tmp_path):
    """zmix --mesh over a panel cache matches the unsharded CLI run."""
    path, _ = gwas_input
    cache = tmp_path / "cache"
    cli.main(["panel-cache"] + _ref_argv(synpanel) + ["-o", str(cache)])
    base = ["zmix", "--input-file", path, "--percentile", "0.5",
            "--interval", "2"] + _ref_argv(synpanel)
    out_1 = tmp_path / "z1.tsv"
    out_m = tmp_path / "zm.tsv"
    cli.main(base + ["-o", str(out_1)])
    cli.main(base + ["--panel-cache", str(cache), "--mesh", "2x4",
                     "-o", str(out_m)])
    df_1 = pd.read_csv(out_1, sep="\t")
    df_m = pd.read_csv(out_m, sep="\t")
    assert list(df_m["Population"]) == list(df_1["Population"])
    np.testing.assert_allclose(df_m["Weight"], df_1["Weight"],
                               rtol=0, atol=0)
    with pytest.raises(SystemExit):
        cli.main(base + ["--mesh", "2x4", "-o", "-"])


def test_cli_panel_cache_and_region(synpanel, gwas_input, region, tmp_path):
    path, _ = gwas_input
    lo, hi = region
    cache = tmp_path / "cache"
    cli.main(["panel-cache"] + _ref_argv(synpanel) + ["-o", str(cache)])
    wgt_file = tmp_path / "wgt.tsv"
    pd.DataFrame({"pop": ["AAA", "BBB"], "wgt": [0.5, 0.5]}).to_csv(
        wgt_file, sep="\t", index=False)
    out = tmp_path / "region.tsv"
    cli.main(["impute-region", "--chr", "22", "--start-bp", str(lo),
              "--end-bp", str(hi), "--pop-wgt-file", str(wgt_file),
              "--input-file", path, "--panel-cache", str(cache),
              "--window-bp", str((hi - lo) // 2 + 1),
              "--wing-size", str(hi - lo)]
             + _ref_argv(synpanel) + ["-o", str(out)])
    df = pd.read_csv(out, sep="\t")
    assert len(df) > 0 and df["bp"].is_unique


def test_cli_genome_jepeg_and_dist_modes(synpanel, gwas_input, region,
                                         tmp_path):
    from gauss_jax.utils import testing as gtest
    path, _ = gwas_input
    lo, hi = region
    annot = tmp_path / "annot.txt"
    gtest.make_annotation(synpanel, str(annot))

    # homogeneous dist through the ledger (--study-pop, no weights)
    out = tmp_path / "dist.tsv"
    cli.main(["impute-genome", "--chr", "22", "--start-bp", str(lo),
              "--end-bp", str(hi), "--study-pop", "EUR",
              "--input-file", path,
              "--window-bp", str((hi - lo) // 2 + 1),
              "--wing-size", str(hi - lo),
              "--chunk-bp", str(hi - lo + 1),
              "--run-dir", str(tmp_path / "rd")] + _ref_argv(synpanel)
             + ["-o", str(out)])
    df = pd.read_csv(out, sep="\t")
    assert len(df) > 0 and "af1ref" in df.columns

    # checkpointed jepeg
    out2 = tmp_path / "jepeg.tsv"
    cli.main(["impute-genome", "--analysis", "jepeg", "--chr", "22",
              "--start-bp", str(lo), "--end-bp", str(hi),
              "--study-pop", "EUR", "--input-file", path,
              "--annotation-file", str(annot),
              "--chunk-bp", str((hi - lo) // 2 + 1),
              "--run-dir", str(tmp_path / "rj")] + _ref_argv(synpanel)
             + ["-o", str(out2)])
    dfj = pd.read_csv(out2, sep="\t")
    assert len(dfj) > 0 and "jepeg_pval" in dfj.columns

    # both pop modes at once must fail fast
    import pytest as _pytest
    with _pytest.raises(SystemExit):
        cli.main(["impute-genome", "--chr", "22", "--start-bp", str(lo),
                  "--end-bp", str(hi), "--study-pop", "EUR",
                  "--pop-wgt-file", "x.tsv", "--input-file", path,
                  "--run-dir", str(tmp_path / "rx")] + _ref_argv(synpanel))


def test_cli_genome_all_failed_exits_nonzero(synpanel, gwas_input, region,
                                             tmp_path, monkeypatch, capsys):
    """A run where EVERY chunk fails must exit non-zero with the first
    error on stderr, not write an empty TSV and exit 0 (reference
    analog: fail-fast Rcpp::stop, src/dist.cpp:145-151)."""
    from gauss_jax.models import genome as genome_mod

    def _boom(self, *a, **k):
        raise RuntimeError("synthetic chunk failure")

    monkeypatch.setattr(genome_mod.PreparedRun, "impute_region", _boom)
    monkeypatch.setattr(genome_mod.PreparedRun, "impute_region_async",
                        _boom)
    path, _ = gwas_input
    lo, hi = region
    wgt_file = tmp_path / "wgt.tsv"
    pd.DataFrame({"pop": ["AAA", "BBB"], "wgt": [0.5, 0.5]}).to_csv(
        wgt_file, sep="\t", index=False)
    out = tmp_path / "empty.tsv"
    argv = ["impute-genome", "--chr", "22", "--start-bp", str(lo),
            "--end-bp", str(hi), "--pop-wgt-file", str(wgt_file),
            "--input-file", path,
            "--chunk-bp", str(hi - lo + 1),
            "--run-dir", str(tmp_path / "rfail")] + _ref_argv(synpanel) \
        + ["-o", str(out)]
    with pytest.raises(SystemExit) as ei:
        cli.main(argv)
    assert ei.value.code not in (0, None)
    assert "every chunk failed" in str(ei.value.code)
    cap = capsys.readouterr()
    assert "synthetic chunk failure" in cap.err
    assert not out.exists()


def test_runner_collect_warns_on_missing_shard(synpanel, gwas_input,
                                               region, tmp_path):
    """A done chunk whose parquet shard vanished must warn, not
    silently shorten the output."""
    import os
    from gauss_jax.io import readers
    from gauss_jax.models.genome import GenomeEngine, PanelStore
    from gauss_jax.models.runner import GenomeRunner
    path, _ = gwas_input
    lo, hi = region
    store = PanelStore.from_bgzf(synpanel.files)
    inp = readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=hi - lo)
    eng = GenomeEngine(store, device_linalg=False)
    runner = GenomeRunner(str(tmp_path / "run"), eng, inp,
                          {"AAA": 0.5, "BBB": 0.5},
                          window_bp=hi - lo + 1, wing_size=hi - lo,
                          chunk_bp=hi - lo + 1)
    runner.plan(22, lo, hi)
    stats = runner.run()
    assert stats["done"] >= 1
    shard = next(
        p for p in (tmp_path / "run" / "results").iterdir()
        if p.suffix == ".parquet")
    os.unlink(shard)
    with pytest.warns(RuntimeWarning, match="shard is missing"):
        df = runner.collect()
    assert len(df) == 0


def test_cli_prep_exports(synpanel, gwas_input, region, tmp_path):
    """Every prep_* export has a CLI surface (reference exports them
    all at the user level, src/RcppExports.cpp:16-355)."""
    import numpy as np
    path, _ = gwas_input
    lo, hi = region
    n_pops = len(synpanel.desc.pops)

    # prep-zmix family -> matrix TSVs with the documented column counts
    for name, extra, ncols in [
            ("prep-zmix", ["--interval", "2"], 1 + n_pops),
            ("prep-zmix2", ["--interval", "7", "--offset", "2"], 1 + n_pops),
            ("prep-zmix3", ["--interval", "5", "--steps", "2"], 1 + n_pops),
            ("prep-zmix4", ["--interval", "7", "--offset", "2"], 2 + n_pops),
            ("prep-zmix5", ["--interval", "2", "--percentile", "0.5"],
             1 + n_pops),
            ("prep-zmix5-sup", ["--interval", "2", "--percentile", "0.5"],
             1 + len(synpanel.desc.sup_pop_order())),
    ]:
        out = tmp_path / f"{name}.tsv"
        cli.main([name, "--input-file", path] + _ref_argv(synpanel)
                 + extra + ["-o", str(out)])
        mat = np.loadtxt(out)
        assert mat.ndim == 2 and mat.shape[1] == ncols and len(mat) > 0, name

    # prep-qcat -> snplist TSV + npz
    out = tmp_path / "pq.tsv"
    npz = tmp_path / "pq.npz"
    cli.main(["prep-qcat", "--chr", "22", "--start-bp", str(lo),
              "--end-bp", str(hi), "--wing-size", str(hi - lo),
              "--study-pop", "EUR", "--input-file", path]
             + _ref_argv(synpanel) + ["-o", str(out), "--npz-out", str(npz)])
    snl = pd.read_csv(out, sep="\t")
    with np.load(npz) as d:
        assert d["cor_mat1"].shape[0] == len(d["z_vec"])
        assert d["cor_mat2"].shape[1] == len(d["z_vec"])
    assert len(snl) > 0

    # prep-recessive-impute -> snplist TSV + npz with 4 cormats
    wgt_file = tmp_path / "wgt.tsv"
    pd.DataFrame({"pop": synpanel.desc.pops[:2], "wgt": [0.5, 0.5]}).to_csv(
        wgt_file, sep="\t", index=False)
    out2 = tmp_path / "pr.tsv"
    npz2 = tmp_path / "pr.npz"
    cli.main(["prep-recessive-impute", "--chr", "22", "--start-bp", str(lo),
              "--end-bp", str(hi), "--wing-size", str(hi - lo),
              "--pop-wgt-file", str(wgt_file), "--input-file", path]
             + _ref_argv(synpanel) + ["-o", str(out2), "--npz-out",
                                      str(npz2)])
    snl2 = pd.read_csv(out2, sep="\t")
    with np.load(npz2) as d:
        M = len(d["zvec"])
        assert d["cormat"].shape == (M, M)
        for k in ("cormat_add", "cormat_dom", "cormat_rec"):
            assert d[k].shape == (len(snl2), M)
