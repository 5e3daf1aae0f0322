#!/usr/bin/env python
"""Benchmark: distmix genome-window imputation throughput on one chip.

Workload (matching BASELINE.json's driver metric): cosmopolitan distmix
imputation over a 33KG-shaped synthetic panel (29 populations, 32,953
subjects -- the real reference panel's dimensions) at chr22-like SNP
density (1500/Mb), reporting imputed SNPs per second per chip.  The
region is ~43 consecutive 1 Mb windows (64k SNPs over 42.7 Mb) --
a genome-scale steady-state measurement, as the reference is driven in
production (one dist/distmix call per window over a chromosome,
SURVEY.md section 2.3).

The "baseline" is the reference implementation's single-thread scalar
algorithm (GAUSS has no published numbers; BASELINE.json published={}),
measured here by timing the literal CalWgtCov scalar loop on a sample
of pairs and pricing the reference's exact operation count
(M*(M-1)/2 + M + U + U*M weighted covariances per window,
src/distmix.cpp:179-236) at that rate.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}
Extra diagnostics go to stderr.
"""

import json
import os
import sys
import time

import numpy as np

WARM_ONLY = "--warm-only" in sys.argv

N_SNPS = int(os.environ.get("GAUSS_BENCH_SNPS", 64000))
BP_SPAN = N_SNPS * 2000 // 3           # 1500 SNPs/Mb density
MEASURED_FRAC = 0.4
WINDOW_BP = 1_000_000
WING_BP = 500_000
CACHE = os.environ.get("GAUSS_BENCH_CACHE",
                       os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    ".bench_cache"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    t0 = time.time()
    import jax

    import gauss_jax  # noqa: F401 (x64)
    from gauss_jax.models.genome import GenomeEngine
    from gauss_jax.utils.benchdata import cached_panel, make_bench_input

    dev = jax.devices()[0]
    log(f"[bench] device: {dev.platform} {dev.device_kind} "
        f"x{len(jax.devices())}")
    if dev.platform == "gpu":
        import subprocess
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        log(f"[bench] card: {smi.stdout.strip()}")

    os.makedirs(CACHE, exist_ok=True)
    t = time.time()
    store = cached_panel(CACHE, N_SNPS, verbose=True, bp_span=BP_SPAN)
    log(f"[bench] panel ready: {store.G.shape[0]} SNPs x "
        f"{store.G.shape[1]} subjects ({time.time()-t:.1f}s)")

    inp = make_bench_input(store, MEASURED_FRAC)
    pop_wgt = {p: 1.0 / store.desc.num_pops for p in store.desc.pops}

    lo = int(store.index["bp"].min())
    hi = int(store.index["bp"].max())

    engine = GenomeEngine(store, snp_bucket=256, device_linalg=True)
    run = engine.prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    log(f"[bench] prepared: {len(run.table)} SNPs in table")

    # pass 1 = warmup: compiles the resident region kernel (persistent
    # compilation cache makes this fast on every run after the first)
    t = time.time()
    res = run.impute_region(lo, hi, window_bp=WINDOW_BP, wing_size=WING_BP)
    n_imputed = int((res["type"] == 0).sum())
    log(f"[bench] pass 1 (incl. compile): {n_imputed} SNPs in "
        f"{time.time()-t:.2f}s")

    if WARM_ONLY:
        # `python bench.py --warm-only`: populate the persistent XLA
        # cache with the exact bench shapes --
        # region kernel above + the LD region kernel below -- so the
        # first real bench/production run skips the 1-4 min cold
        # compiles (see README "First run / warmup").
        t = time.time()
        run.ld_region(lo, hi, window_bp=WINDOW_BP)
        log(f"[bench] LD kernel warmed ({time.time()-t:.1f}s)")
        print(json.dumps({"metric": "warm-only", "value": 1,
                          "unit": "ok", "vs_baseline": 0}))
        return
    # median of 3 timed blocking passes (diagnostic: shows the
    # unpipelined per-region wall time incl. dispatch+fetch+assembly)
    times = []
    for _ in range(3):
        t = time.time()
        res = run.impute_region(lo, hi, window_bp=WINDOW_BP,
                                wing_size=WING_BP)
        times.append(time.time() - t)
    elapsed = sorted(times)[1]
    n_imputed = int((res["type"] == 0).sum())
    log(f"[bench] blocking pass: {n_imputed} SNPs in {elapsed:.2f}s "
        f"(median of {[f'{x:.2f}' for x in times]}) -> "
        f"{n_imputed/elapsed:.1f} SNPs/s")

    # HEADLINE: pipelined steady state -- the production genome-run
    # pattern (impute_regions keeps 2 regions in flight, so region N's
    # fetch + frame assembly overlap region N+1's device compute).
    # 8 passes amortize the pipeline fill/drain edges into the mean.
    N_PIPE = 8
    t = time.time()
    prev = None
    for _ in range(N_PIPE):
        h = run.impute_region_async(lo, hi, window_bp=WINDOW_BP,
                                    wing_size=WING_BP)
        if prev is not None:
            res = prev.result()
        prev = h
    res = prev.result()
    elapsed_pipe = (time.time() - t) / N_PIPE
    rate = n_imputed / elapsed_pipe
    log(f"[bench] pipelined steady state: {n_imputed} SNPs/region x "
        f"{N_PIPE} regions in {N_PIPE*elapsed_pipe:.2f}s -> "
        f"{rate:.1f} SNPs/s/chip")

    # secondary: ancestry-weighted LD throughput (computeLD windows)
    t = time.time()
    lds = run.ld_region(lo, hi, window_bp=WINDOW_BP, fetch="i16tri")
    log(f"[bench] LD warmup: {len(lds)} windows "
        f"({time.time()-t:.1f}s incl. compile)")
    t = time.time()
    lds = run.ld_region(lo, hi, window_bp=WINDOW_BP, fetch="i16tri")
    ld_elapsed = time.time() - t
    log(f"[bench] computeLD: {len(lds)} windows in {ld_elapsed:.2f}s "
        f"-> {len(lds)/ld_elapsed:.1f} LD windows/s")

    # accuracy cross-check: fused device path vs host f64 path on the
    # first window (the host path re-derives B11/B21 with float64
    # combines and host linalg; the region rows for window 1 must
    # match).  No device gather-kernel compile is involved.
    eng_h = GenomeEngine(store, snp_bucket=256, device_linalg=False)
    run_h = eng_h.prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    a = run_h.impute_window(lo, lo + WINDOW_BP - 1, WING_BP).table
    bmask = (res["bp"] >= lo) & (res["bp"] <= lo + WINDOW_BP - 1)
    b = res[bmask].reset_index(drop=True)
    assert len(a) == len(b), (len(a), len(b))
    imp = a["type"].to_numpy() == 0
    max_dz = float(np.abs(a["z"].to_numpy()[imp]
                          - b["z"].to_numpy()[imp]).max())
    log(f"[bench] fused-vs-host max|dZ| = {max_dz:.2e}")

    # reference-style scalar baseline estimate
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    import oracle
    sizes = list(run.pop_sizes)
    wgts = list(run.wgts)
    Gs = store.G[:50, run.subj_cols]
    t = time.time()
    n_pairs = 0
    for i in range(10):
        for j in range(i + 1, 10):
            oracle.cal_wgt_cov(Gs[i], Gs[j], sizes, wgts)
            n_pairs += 1
    t_pair = (time.time() - t) / n_pairs
    # operation count of the reference per window over the same region
    total_pairs = 0
    pos = lo
    bp = run.table["bp"].to_numpy()
    typ = run.table["type"].to_numpy()
    while pos <= hi:
        pe = min(pos + WINDOW_BP - 1, hi)
        m = int(((bp >= pos - WING_BP) & (bp <= pe + WING_BP) & (typ == 1)).sum())
        u = int(((bp >= pos) & (bp <= pe) & (typ == 0)).sum())
        total_pairs += m * (m - 1) // 2 + m + u + u * m
        pos = pe + 1
    est_ref_time = total_pairs * t_pair
    speedup = est_ref_time / elapsed_pipe
    log(f"[bench] scalar-baseline estimate: {t_pair*1e6:.1f} us/pair x "
        f"{total_pairs:.3g} pairs = {est_ref_time:.0f}s -> speedup {speedup:.0f}x")
    log(f"[bench] total bench time {time.time()-t0:.1f}s")

    print(json.dumps({
        "metric": "distmix imputed SNPs/s/chip (33KG-shape panel, chr22-like)",
        "value": round(rate, 1),
        "unit": "SNPs/s/chip",
        "vs_baseline": round(speedup, 1),
    }))


if __name__ == "__main__":
    main()
