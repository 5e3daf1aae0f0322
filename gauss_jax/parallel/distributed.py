"""Multi-host orchestration: jax.distributed + host-sharded panels.

The reference is strictly single-process (SURVEY.md section 2.3); this
is the green-field scale-out layer.  The design follows the
panel's natural structure:

* **within a slice (NVLink)**: the subject axis shards across chips
  (mesh.subject_shard_layout gives every shard an equal slice of every
  population) and partial sufficient statistics combine with one psum
  per window -- cheap, bandwidth-bound collectives over NVLink;
* **across hosts (DCN)**: windows are embarrassingly parallel, so the
  window axis of the mesh maps to hosts and no genotype data ever
  crosses DCN -- each host decodes/loads only the panel rows its
  windows touch (PanelStore.from_bgzf with a bp range), and only the
  tiny per-window z/info results are gathered.

Process bootstrap is standard JAX multi-process:

    from gauss_jax.parallel import distributed
    distributed.initialize()            # reads JAX_COORDINATOR etc.
    mesh = distributed.global_mesh(n_window=..., n_subject=...)

Under a single process this degrades to the local device mesh, so the
same program runs 1-chip, 1-host-N-chip and M-host unchanged.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed from args or standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    No-op when neither args nor env are present (single process)."""
    import jax

    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None:
        return
    kwargs = {"coordinator_address": addr}
    npz = (num_processes if num_processes is not None
           else os.environ.get("JAX_NUM_PROCESSES"))
    pid = (process_id if process_id is not None
           else os.environ.get("JAX_PROCESS_ID"))
    if npz is not None:
        kwargs["num_processes"] = int(npz)
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)


def global_mesh(n_window: Optional[int] = None,
                n_subject: Optional[int] = None):
    """(window x subject) mesh over ALL processes' devices.

    Defaults: the subject axis spans the devices of one process (so
    its psum rides NVLink within the host's chips) and the window axis
    spans processes (independent work, nothing but results on DCN).
    """
    import jax
    from jax.sharding import Mesh

    devices = np.array(jax.devices())
    n_local = jax.local_device_count()
    n_total = len(devices)
    if n_subject is None:
        n_subject = n_local
    if n_window is None:
        n_window = n_total // n_subject
    if n_window * n_subject != n_total:
        raise ValueError(
            f"mesh {n_window}x{n_subject} != {n_total} devices")
    return Mesh(devices.reshape(n_window, n_subject),
                axis_names=("window", "subject"))


def host_window_ranges(start_bp: int, end_bp: int, window_bp: int,
                       num_hosts: int, host_id: int
                       ) -> Tuple[int, int]:
    """Contiguous bp sub-range of [start_bp, end_bp] owned by one host
    when windows are striped across hosts in contiguous blocks (keeps
    each host's panel decode to one bp range)."""
    n_windows = max(1, -(-(end_bp - start_bp + 1) // window_bp))
    per = -(-n_windows // num_hosts)
    lo_w = host_id * per
    hi_w = min(n_windows, lo_w + per)
    if lo_w >= n_windows:
        return (end_bp + 1, end_bp)     # empty range
    lo = start_bp + lo_w * window_bp
    hi = min(end_bp, start_bp + hi_w * window_bp - 1)
    return (lo, hi)


def process_info() -> Tuple[int, int]:
    """(num_processes, process_id) of the running job (1, 0 when
    jax.distributed was never initialized)."""
    import jax
    return jax.process_count(), jax.process_index()


def barrier(name: str) -> None:
    """Synchronize all processes (no-op single-process).  Rides the
    cross-process collective transport (gloo on CPU, NCCL on GPU)."""
    import jax
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)


def host_run_dir(run_dir: str, process_id: Optional[int] = None) -> str:
    """Per-host ledger directory under a shared run dir: hosts write
    disjoint manifests/shards, so no cross-process file races."""
    if process_id is None:
        process_id = process_info()[1]
    return os.path.join(run_dir, f"host{process_id:03d}")


def run_genome_multihost(make_runner, chrom: int, start_bp: int,
                         end_bp: int, window_bp: int, run_dir: str):
    """Genome-scale run striped across hosts.

    Windows are embarrassingly parallel (the reference's genome story IS
    a user loop over windows, SURVEY.md section 2.3), so each host owns a
    contiguous window block (host_window_ranges), runs its own
    checkpointed GenomeRunner in ``run_dir/hostNNN`` -- decoding only its
    own panel range in streaming mode -- and only result shards cross
    host boundaries.  ``make_runner(host_dir, lo, hi)`` builds the
    runner for one host's sub-range.

    Returns the merged DataFrame on process 0, None elsewhere.
    """
    import pandas as pd

    num, pid = process_info()
    lo, hi = host_window_ranges(start_bp, end_bp, window_bp, num, pid)
    all_failed_msg = None
    if lo <= hi:
        runner = make_runner(host_run_dir(run_dir, pid), lo, hi)
        runner.plan(chrom, lo, hi)
        stats = runner.run()
        if stats["failed"]:
            # surface per-host failures before the barrier so a wedged
            # chunk doesn't look like a hang on the other hosts
            import sys
            print(f"[gauss_jax] host {pid}: {stats['failed']} chunk(s) "
                  "failed (see manifest)", file=sys.stderr)
        if stats["done"] + stats["skipped"] == 0:
            first = next((c for c in runner.chunks.values()
                          if c.status == "failed"), None)
            detail = ((first.error or "").splitlines()[0]
                      if first is not None else "no chunks planned")
            all_failed_msg = (
                f"host {pid}: every chunk failed; merging would emit "
                f"silence for [{lo}, {hi}] (first error: {detail})")
    # hit the barrier even on total failure so the other hosts don't
    # hang, THEN raise loudly instead of contributing empty results
    barrier("gauss_jax:genome_multihost")
    if all_failed_msg is not None:
        raise RuntimeError(all_failed_msg)
    if pid != 0:
        return None
    return collect_multihost(run_dir)


def collect_multihost(run_dir: str):
    """Concatenate every host's completed shards in genomic order."""
    import json

    import pandas as pd

    frames = []
    hosts = sorted(d for d in os.listdir(run_dir) if d.startswith("host"))
    entries = []
    for h in hosts:
        mpath = os.path.join(run_dir, h, "manifest.json")
        if not os.path.exists(mpath):
            continue
        with open(mpath) as fh:
            man = json.load(fh)
        for c in man.get("chunks", []):
            if c["status"] != "done":
                continue
            key = f"{c['chrom']}_{c['start_bp']}_{c['end_bp']}"
            entries.append((c["chrom"], c["start_bp"],
                            os.path.join(run_dir, h, "results",
                                         f"{key}.parquet")))
    for _, _, path in sorted(entries):
        if os.path.exists(path):
            frames.append(pd.read_parquet(path))
        else:
            import warnings
            warnings.warn(
                f"multihost merge: chunk marked done but shard missing "
                f"({path}); merged output will have a hole", RuntimeWarning)
    if not frames:
        return pd.DataFrame()
    return pd.concat(frames, ignore_index=True)
