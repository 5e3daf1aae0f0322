"""Two-process multi-host run: localhost coordinator, window striping.

Each process owns a contiguous window block (host_window_ranges), runs
its own checkpointed ledger, and process 0 merges -- output must be
identical to a single-process run over the same range.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from gauss_jax.parallel import distributed


def test_host_window_ranges_partition():
    """Blocks must tile [start, end] exactly, window-aligned, for any
    host count (incl. more hosts than windows)."""
    start, end, w = 1_000_000, 3_399_999, 600_000
    for num_hosts in (1, 2, 3, 7):
        covered = []
        for h in range(num_hosts):
            lo, hi = distributed.host_window_ranges(start, end, w,
                                                    num_hosts, h)
            if lo <= hi:
                assert (lo - start) % w == 0
                covered.append((lo, hi))
        covered.sort()
        assert covered[0][0] == start and covered[-1][1] == end
        for (a_lo, a_hi), (b_lo, b_hi) in zip(covered, covered[1:]):
            assert b_lo == a_hi + 1


@pytest.mark.slow
def test_two_process_cpu_matches_single(synpanel, gwas_input, tmp_path):
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    window = (hi - lo) // 4 + 1          # 4 windows, 2 per host
    wgt_file = tmp_path / "wgt.tsv"
    pd.DataFrame({"pop": ["AAA", "BBB"], "wgt": [0.5, 0.5]}).to_csv(
        wgt_file, sep="\t", index=False)

    base = ["impute-genome", "--chr", "22", "--start-bp", str(lo),
            "--end-bp", str(hi), "--pop-wgt-file", str(wgt_file),
            "--input-file", path,
            "--window-bp", str(window), "--wing-size", str(window),
            "--chunk-bp", str(window), "--host-linalg",
            "--reference-index-file", synpanel.files.index_file,
            "--reference-data-file", synpanel.files.data_file,
            "--reference-pop-desc-file", synpanel.files.pop_desc_file]

    # single-process reference, in-process (pytest is already on CPU)
    from gauss_jax import cli
    ref_out = tmp_path / "ref.tsv"
    cli.main(base + ["--run-dir", str(tmp_path / "run1"),
                     "-o", str(ref_out)])
    ref = pd.read_csv(ref_out, sep="\t")

    # two coordinated processes over a shared run dir
    mh_out = tmp_path / "mh.tsv"
    run_dir = tmp_path / "run_mh"
    port = 12000 + (os.getpid() % 2000)
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
            "JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gauss_jax"] + base
            + ["--multihost", "--run-dir", str(run_dir),
               "-o", str(mh_out)],
            env=env, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    got = pd.read_csv(mh_out, sep="\t")
    # identical windows (chunk == window, window-aligned striping) =>
    # identical rows in genomic order
    assert len(got) == len(ref)
    pd.testing.assert_frame_equal(
        got.reset_index(drop=True), ref.reset_index(drop=True),
        check_exact=False, rtol=1e-12, atol=1e-12)
    # per-host ledgers exist and are disjoint
    hosts = sorted(d for d in os.listdir(run_dir) if d.startswith("host"))
    assert hosts == ["host000", "host001"]
