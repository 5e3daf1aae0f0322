"""Checkpoint/resume + failure tolerance of the genome runner."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from gauss_jax.config import PanelFiles
from gauss_jax.io import readers
from gauss_jax.models.genome import GenomeEngine, PanelStore
from gauss_jax.models.runner import GenomeRunner
from gauss_jax.utils.testing import make_gwas_input, make_synthetic_panel


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("runner_panel")
    p = make_synthetic_panel(str(d), n_snps=900, bp_start=1_000_000,
                             bp_step=2_000, seed=11)
    zin = str(d / "zin.txt")
    make_gwas_input(p, zin, measured_frac=0.5, seed=12)
    store = PanelStore.from_bgzf(p.files, chrom=22)
    inp = readers.read_input_z(zin, chrom=22, start_bp=1_000_000,
                               end_bp=2_800_000, wing_size=200_000)
    pop_wgt = {pop: 1.0 / len(p.desc.pops) for pop in p.desc.pops}
    return store, inp, pop_wgt, p.files


def _runner(tmp_path, setup, **kw):
    store, inp, pop_wgt = setup[:3]
    eng = GenomeEngine(store, snp_bucket=64, device_linalg=True)
    return GenomeRunner(str(tmp_path), eng, inp, pop_wgt,
                        window_bp=600_000, wing_size=200_000,
                        chunk_bp=600_000, **kw)


def test_run_and_collect(tmp_path, setup):
    r = _runner(tmp_path / "run1", setup)
    r.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
    stats = r.run()
    assert stats["failed"] == 0 and stats["done"] >= 2
    df = r.collect()
    assert len(df) > 0
    assert (df["type"] == 0).any()
    # manifest persisted
    man = json.load(open(os.path.join(str(tmp_path / "run1"),
                                      "manifest.json")))
    assert all(c["status"] == "done" for c in man["chunks"])


def test_resume_skips_done(tmp_path, setup):
    d = tmp_path / "run2"
    r = _runner(d, setup)
    r.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
    r.run()
    # a fresh runner over the same dir resumes: everything skipped
    r2 = _runner(d, setup)
    stats = r2.run(resume=True)
    assert stats["done"] == 0 and stats["skipped"] >= 2
    assert len(r2.collect()) == len(r.collect())


def test_failure_recorded_then_resumed(tmp_path, setup, monkeypatch):
    d = tmp_path / "run3"
    r = _runner(d, setup)
    r.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)

    # inject a one-shot failure into the second chunk
    real = GenomeRunner._prepared
    calls = {"n": 0}

    class Boom(RuntimeError):
        pass

    def flaky(self, cs=None):
        run = real(self, cs)
        orig = run.impute_region_async

        def wrapped(start_bp, end_bp, **kw):
            calls["n"] += 1
            if calls["n"] == 2 and not calls.get("healed"):
                calls["healed"] = True
                raise Boom("injected chunk failure")
            return orig(start_bp, end_bp, **kw)

        run.impute_region_async = wrapped
        return run

    monkeypatch.setattr(GenomeRunner, "_prepared", flaky)
    stats = r.run()
    assert stats["failed"] == 1
    st = r.status()
    assert st["failed"] == 1
    failed = [c for c in r.chunks.values() if c.status == "failed"]
    assert "injected chunk failure" in failed[0].error

    # resume: failed chunk retried and completes
    monkeypatch.setattr(GenomeRunner, "_prepared", real)
    stats2 = r.run(resume=True)
    assert stats2["failed"] == 0 and stats2["done"] == 1
    assert r.status()["failed"] == 0


def test_restart_retries_failed_chunks(tmp_path, setup, monkeypatch):
    """resume=False (--restart) recomputes everything INCLUDING chunks
    previously marked failed (round-1 advisor finding)."""
    d = tmp_path / "run3b"
    r = _runner(d, setup)
    r.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)

    real = GenomeRunner._prepared
    calls = {"n": 0}

    def flaky(self, cs=None):
        run = real(self, cs)
        orig = run.impute_region_async

        def wrapped(start_bp, end_bp, **kw):
            calls["n"] += 1
            if calls["n"] == 2 and not calls.get("healed"):
                calls["healed"] = True
                raise RuntimeError("injected chunk failure")
            return orig(start_bp, end_bp, **kw)

        run.impute_region_async = wrapped
        return run

    monkeypatch.setattr(GenomeRunner, "_prepared", flaky)
    assert r.run()["failed"] == 1
    monkeypatch.setattr(GenomeRunner, "_prepared", real)

    # restart: nothing skipped, failed chunk recomputed
    stats = r.run(resume=False)
    assert stats["skipped"] == 0 and stats["failed"] == 0
    assert r.status()["failed"] == 0 and r.status()["pending"] == 0
    # every planned bp range present in the collected output
    df = r.collect()
    assert all(c.status == "done" for c in r.chunks.values())
    assert len(df) > 0


def test_manifest_param_mismatch_raises(tmp_path, setup):
    d = tmp_path / "run_mismatch"
    r = _runner(d, setup)
    r.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
    r.run()
    # resuming with different window params or analysis must refuse
    with pytest.raises(ValueError, match="different"):
        _runner(d, setup, analysis="qcat")
    store, inp, pop_wgt = setup[:3]
    eng = GenomeEngine(store, snp_bucket=64, device_linalg=True)
    with pytest.raises(ValueError, match="window_bp"):
        GenomeRunner(str(d), eng, inp, pop_wgt, window_bp=500_000,
                     wing_size=200_000, chunk_bp=600_000)


def test_runner_on_mesh_matches_single_device(tmp_path, setup):
    """Checkpointed genome run over a (2 x 4) device mesh == 1-device."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from gauss_jax.parallel.mesh import make_mesh

    store, inp, pop_wgt = setup[:3]
    eng_m = GenomeEngine(store, snp_bucket=64, mesh=make_mesh(2, 4))
    r_m = GenomeRunner(str(tmp_path / "mesh"), eng_m, inp, pop_wgt,
                       window_bp=600_000, wing_size=200_000,
                       chunk_bp=600_000)
    r_m.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
    assert r_m.run()["failed"] == 0
    df_m = r_m.collect()

    r_1 = _runner(tmp_path / "one", setup)
    r_1.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
    r_1.run()
    df_1 = r_1.collect()
    assert len(df_m) == len(df_1) > 0
    np.testing.assert_allclose(df_m["z"].to_numpy(), df_1["z"].to_numpy(),
                               rtol=2e-5, atol=2e-5)


def test_streaming_matches_resident(tmp_path, setup):
    """Per-chunk panel decode (streaming) == resident-panel run."""
    store, inp, pop_wgt = setup[:3]
    d1 = tmp_path / "resident"
    r1 = _runner(d1, setup)
    r1.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
    r1.run()

    # streaming: engine starts with NO store; panel decoded per chunk
    d2 = tmp_path / "streaming"
    eng = GenomeEngine(None, snp_bucket=64, device_linalg=True)
    r2 = GenomeRunner(str(d2), eng, inp, pop_wgt,
                      window_bp=600_000, wing_size=200_000,
                      chunk_bp=600_000, panel_files=setup[3])
    r2.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
    stats = r2.run()
    assert stats["failed"] == 0
    a = r1.collect()
    b = r2.collect()
    assert len(a) == len(b)
    np.testing.assert_array_equal(a["rsid"].to_numpy(), b["rsid"].to_numpy())
    np.testing.assert_allclose(a["z"].to_numpy(), b["z"].to_numpy(),
                               rtol=0, atol=0)


def test_qcat_analysis_runner(tmp_path, setup):
    r = _runner(tmp_path / "qcatrun", setup, analysis="qcat")
    r.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
    stats = r.run()
    assert stats["failed"] == 0 and stats["done"] >= 2
    df = r.collect()
    assert "qcat_chisq" in df.columns and len(df) > 0


def test_dist_homog_analysis_runner(tmp_path, setup):
    """analysis='impute' with study_pop runs the homogeneous dist path
    through the ledger and matches an unchunked prepare_homog run."""
    store, inp, _, _ = setup
    eng = GenomeEngine(store, snp_bucket=64, device_linalg=True)
    r = GenomeRunner(str(tmp_path / "dist"), eng, inp, study_pop="EUR",
                     window_bp=600_000, wing_size=200_000,
                     chunk_bp=600_000)
    r.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
    stats = r.run()
    assert stats["failed"] == 0 and stats["done"] >= 2
    got = r.collect()

    direct = eng.prepare_homog(inp, "EUR").impute_region(
        1_000_000, 2_800_000, window_bp=600_000, wing_size=200_000)
    m = got.merge(direct, on=["rsid", "bp"], suffixes=("_r", "_d"))
    assert len(m) == len(direct)
    # per-chunk (Mp, Up) buckets differ from the region-unified shape,
    # so f32 reduction order shifts the solves by ~1e-5
    np.testing.assert_allclose(m["z_r"], m["z_d"], rtol=2e-4, atol=2e-5)


def test_ld_analysis_runner(tmp_path, setup):
    """analysis='ld' persists window matrices and collect_ld round-trips
    them identically to a direct ld_region call."""
    store, inp, pop_wgt, _ = setup
    eng = GenomeEngine(store, snp_bucket=64, device_linalg=True)
    r = GenomeRunner(str(tmp_path / "ld"), eng, inp, pop_wgt,
                     window_bp=600_000, wing_size=200_000,
                     chunk_bp=1_200_000, analysis="ld")
    r.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
    stats = r.run()
    assert stats["failed"] == 0
    blocks = r.collect_ld()
    direct = eng.prepare_mix(inp, pop_wgt).ld_region(
        1_000_000, 2_800_000, window_bp=600_000)
    assert len(blocks) == len(direct)
    for b, d in zip(blocks, direct):
        assert list(b["snplist"]["rsid"]) == list(d["snplist"]["rsid"])
        np.testing.assert_allclose(b["cormat"], d["cormat"],
                                   rtol=0, atol=0)


def test_jepeg_analysis_runner(tmp_path, setup, tmp_path_factory):
    """analysis='jepeg' partitions genes across chunks; union equals the
    unchunked engine-resident run."""
    from gauss_jax.utils.testing import make_annotation
    store, inp, pop_wgt, files = setup

    class _P:  # make_annotation wants .index_df
        index_df = store.index
    ad = tmp_path_factory.mktemp("runner_annot")
    apath = str(ad / "annot.txt")
    make_annotation(_P, apath)
    annot = readers.read_annotation(apath)

    eng = GenomeEngine(store, snp_bucket=64, device_linalg=True)
    r = GenomeRunner(str(tmp_path / "jep"), eng, inp, pop_wgt,
                     window_bp=600_000, wing_size=200_000,
                     chunk_bp=600_000, analysis="jepeg", annot_df=annot)
    r.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
    stats = r.run()
    assert stats["failed"] == 0
    got = r.collect().sort_values("geneid").reset_index(drop=True)

    direct = eng.prepare_genes(inp, annot, pop_wgt=pop_wgt).jepeg_region(
        1_000_000, 2_800_000).sort_values("geneid").reset_index(drop=True)
    assert list(got["geneid"]) == list(direct["geneid"])
    np.testing.assert_allclose(got["chisq"], direct["chisq"],
                               rtol=0, atol=0)


def test_runner_rejects_bad_pop_mode(tmp_path, setup):
    store, inp, pop_wgt, _ = setup
    eng = GenomeEngine(store, device_linalg=True)
    with pytest.raises(ValueError, match="exactly one"):
        GenomeRunner(str(tmp_path / "x"), eng, inp, pop_wgt,
                     study_pop="EUR")
    with pytest.raises(ValueError, match="exactly one"):
        GenomeRunner(str(tmp_path / "y"), eng, inp)
    with pytest.raises(ValueError, match="annot_df"):
        GenomeRunner(str(tmp_path / "z"), eng, inp, pop_wgt,
                     analysis="jepeg")
    with pytest.raises(ValueError, match="pop_wgt"):
        GenomeRunner(str(tmp_path / "w"), eng, inp, study_pop="EUR",
                     analysis="ld")


def test_streaming_prefetch_overlaps_decode(tmp_path, setup):
    """In streaming mode, chunk N+1's panel decode runs on a worker
    thread while chunk N computes: the trace must show the later
    chunks' decode_chunk phases as prefetched (already-resolved
    futures) and the results must be identical to the non-prefetched
    path (covered by test_streaming_matches_resident)."""
    from gauss_jax.utils.timing import Tracer
    _, inp, pop_wgt, panel_files = setup[:4]
    tr = Tracer()
    eng = GenomeEngine(None, snp_bucket=64, device_linalg=True)
    r = GenomeRunner(str(tmp_path / "pf"), eng, inp, pop_wgt,
                     window_bp=600_000, wing_size=200_000,
                     chunk_bp=600_000, panel_files=panel_files, tracer=tr)
    r.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
    stats = r.run()
    assert stats["failed"] == 0 and stats["done"] >= 2
    decodes = [p for p in tr.phases if p.name.endswith("decode_chunk")]
    assert len(decodes) == stats["done"]
    assert decodes[0].meta["prefetched"] is False   # nothing to overlap yet
    assert all(p.meta["prefetched"] for p in decodes[1:])
    assert r._prefetch == {}                        # cleaned up


def test_jepeg_runner_on_mesh(tmp_path, setup, synpanel):
    """Checkpointed analysis='jepeg' over a (2 x 4) mesh == 1-device."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from gauss_jax.io import readers
    from gauss_jax.parallel.mesh import make_mesh
    from gauss_jax.utils import testing as gtest
    store, inp, pop_wgt = setup[:3]
    annot_path = tmp_path / "annot.txt"
    gtest.make_annotation(synpanel, str(annot_path))
    annot = readers.read_annotation(str(annot_path))

    def _run(d, mesh):
        eng = GenomeEngine(store, snp_bucket=64, mesh=mesh)
        r = GenomeRunner(str(d), eng, inp, pop_wgt, analysis="jepeg",
                         annot_df=annot, window_bp=600_000,
                         wing_size=200_000, chunk_bp=900_000)
        r.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)
        stats = r.run()
        assert stats["failed"] == 0
        return r.collect()

    df_m = _run(tmp_path / "mesh", make_mesh(2, 4))
    df_1 = _run(tmp_path / "one", None)
    assert len(df_m) == len(df_1) > 0
    np.testing.assert_allclose(df_m["chisq"].to_numpy(),
                               df_1["chisq"].to_numpy(),
                               rtol=1e-12, atol=1e-12)


def test_fetch_failure_attributed_to_its_chunk(tmp_path, setup,
                                               monkeypatch):
    """Pipelined impute: a failure surfacing at FETCH time (the
    in-flight handle's result()) must be recorded against the chunk
    that was dispatched, not the one whose dispatch triggered the
    fetch; with max_failures it re-raises without mislabeling."""
    d = tmp_path / "run_fetchfail"
    r = _runner(d, setup)
    r.plan(chrom=22, start_bp=1_000_000, end_bp=2_800_000)

    real = GenomeRunner._prepared
    calls = {"n": 0}

    class _BoomHandle:
        def result(self):
            raise RuntimeError("injected fetch failure")

    def flaky(self, cs=None):
        run = real(self, cs)
        orig = run.impute_region_async

        def wrapped(start_bp, end_bp, **kw):
            calls["n"] += 1
            if calls["n"] == 1 and not calls.get("healed"):
                calls["healed"] = True
                return _BoomHandle()
            return orig(start_bp, end_bp, **kw)

        run.impute_region_async = wrapped
        return run

    monkeypatch.setattr(GenomeRunner, "_prepared", flaky)
    stats = r.run()
    assert stats["failed"] == 1
    failed = [c for c in r.chunks.values() if c.status == "failed"]
    assert len(failed) == 1
    # the FIRST chunk (whose handle failed) carries the error
    assert failed[0].start_bp == 1_000_000
    assert "injected fetch failure" in failed[0].error
    # every other chunk completed normally
    assert sum(c.status == "done" for c in r.chunks.values()) \
        == len(r.chunks) - 1
