#!/usr/bin/env python
"""Chip smoke: the main path on one GPU, checked against its references.

    python chip_smoke.py            # one GPU (H100), ~5 min
    python chip_smoke.py --mesh4    # four GPUs of one host: the engine
                                    # mesh and its one-card comparison only

Phases (one card):
  1. device: JAX version, card name and power limit; exits non-zero,
     printing no result, unless JAX runs on a GPU;
  2. Gram: the Pallas kernel as compiled for the card against the
     float64 oracle at 33KG width (29 populations, 1280-row bands,
     batched offsets, symmetric skip) and in pooled single-segment mode;
     kernel and XLA-form times at the 43-window bench shapes; the f32
     integer sufficient statistics against int64;
  3. main path on a 33KG-shaped 64k-SNP region (43 windows of 1 Mb,
     500 kb wings): distmix impute_region + pipelined
     impute_region_async vs the float64 host path, pooled dist on one
     population vs its host path, ld_region(fetch="f32") vs computeLD's
     kernels; compile seconds and peak device memory.

The last line of standard output is one JSON object naming the device.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

WINDOW_BP = 1_000_000
WING_BP = 500_000
N_SNPS = 64_000
BP_SPAN = N_SNPS * 2000 // 3           # 1500 SNPs/Mb, chr22-like
GRAM_TOL = 1e-6
DZ_TOL = 5e-5
DR_TOL = 1e-5


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def median_time(f, *args, n=5):
    """Median wall seconds of f(*args) over n warm runs (first call
    compiles and is not counted)."""
    import jax
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def phase_device(n_cards):
    import jax
    devs = jax.devices()
    log(f"jax {jax.__version__}, devices {devs}")
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX runs on {devs[0].platform}", file=sys.stderr)
        sys.exit(1)
    if len(devs) < n_cards:
        print(f"needs {n_cards} GPUs, found {len(devs)}", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    return card


def _gram_panel(key, n_rows, sizes, padded):
    """Shifted-dosage-like int8 rows in [-2, 2], zero on padded columns."""
    import jax
    import jax.numpy as jnp
    valid = np.zeros(sum(padded), np.int8)
    lo = 0
    for s, sp in zip(sizes, padded):
        valid[lo:lo + s] = 1
        lo += sp
    G = jax.random.randint(key, (n_rows, len(valid)), -2, 3, jnp.int8)
    return G * jnp.asarray(valid)[None, :]


def phase_gram():
    import jax
    import jax.numpy as jnp
    from gauss_jax.core import stats
    from gauss_jax.ops import pallas_gram as pg
    from gauss_jax.utils.benchdata import POPS_33KG

    sizes = [p[1] for p in POPS_33KG]
    padded = [-(-s // pg.K_TILE) * pg.K_TILE for s in sizes]
    w = np.random.default_rng(0).dirichlet(np.ones(len(sizes)))
    W, Mp, Up = 43, 1280, 1024
    log(f"gram: {len(sizes)} populations, {sum(sizes)} subjects padded "
        f"to S={sum(padded)}; bands Mp={Mp}, Up={Up}, W={W}")
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    Xm = _gram_panel(k1, W * Mp, sizes, padded)
    Xu = _gram_panel(k2, W * Up, sizes, padded)
    m_t0 = jnp.arange(W, dtype=jnp.int32) * (Mp // pg.ROW_TILE)
    u_t0 = jnp.arange(W, dtype=jnp.int32) * (Up // pg.ROW_TILE)

    def region(gram, Xm, Xu, m_t0, u_t0, **kw):
        mm = gram(Xm, Xm, sizes, padded, w, nx=Mp, ny=Mp, x_tile0=m_t0,
                  y_tile0=m_t0, **kw)
        um = gram(Xu, Xm, sizes, padded, w, nx=Up, ny=Mp, x_tile0=u_t0,
                  y_tile0=m_t0)
        return mm, um

    kern = jax.jit(lambda *a: region(pg.weighted_gram_t1, *a,
                                     n_sym=Mp // pg.BLOCK))
    xla = jax.jit(lambda *a: region(pg.weighted_gram_t1_xla, *a))
    args = (Xm, Xu, m_t0, u_t0)
    t = time.perf_counter()
    mm, um = jax.block_until_ready(kern(*args))
    log(f"gram kernel compiled + first run {time.perf_counter() - t:.1f}s")
    for wi in (0, W - 1):
        X = np.asarray(jnp.concatenate([Xm[wi * Mp:(wi + 1) * Mp],
                                        Xu[wi * Up:(wi + 1) * Up]]))
        ref = pg.weighted_gram_reference(X, X[:Mp], sizes, padded, w)
        got = np.concatenate([np.asarray(pg.mirror_lower(mm[wi])),
                              np.asarray(um[wi])]).astype(np.float64)
        rel = float(np.abs(got - ref).max() / np.abs(ref).max())
        log(f"gram kernel vs float64 oracle, window {wi}: rel {rel:.3e} "
            f"(bound {GRAM_TOL:.0e})")
        assert rel <= GRAM_TOL, rel
    del mm, um

    t_k = median_time(kern, *args)
    t_x = median_time(xla, *args)
    ops = 2 * W * (Mp * Mp + Up * Mp) * sum(padded)
    log(f"gram time at bench shapes (median of 5): kernel {t_k * 1e3:.2f} "
        f"ms, XLA form {t_x * 1e3:.2f} ms; {ops / 1e12:.2f} T int8 ops "
        f"dense-equivalent")
    del Xm, Xu, kern, xla

    # pooled single-segment mode (homogeneous dist): one population
    # over the padded axis, beta == 1
    n = 6360
    p1 = [-(-n // pg.K_TILE) * pg.K_TILE]
    X = _gram_panel(jax.random.PRNGKey(3), 2 * pg.ROW_TILE * 3, [n], p1)
    t0 = jnp.asarray([0, 2, 4], jnp.int32)
    wp = [(n - 1.0) / (n * n)]
    out = pg.mirror_lower(pg.weighted_gram_t1(
        X, X, [n], p1, wp, n_sym=2 * pg.ROW_TILE // pg.BLOCK,
        nx=2 * pg.ROW_TILE, ny=2 * pg.ROW_TILE, x_tile0=t0, y_tile0=t0))
    Xh = np.asarray(X)
    for i, o in enumerate(np.asarray(t0)):
        band = Xh[o * pg.ROW_TILE:(o + 2) * pg.ROW_TILE]
        ref = pg.weighted_gram_reference(band, band, [n], p1, wp)
        rel = float(np.abs(np.asarray(out[i]) - ref).max()
                    / np.abs(ref).max())
        assert rel <= GRAM_TOL, rel
    log(f"gram kernel pooled mode vs float64 oracle: rel {rel:.3e}")

    # f32 sufficient statistics (host parity path) stay integer-exact
    # when the GPU runs f32 dots in TF32
    G = np.random.default_rng(1).integers(0, 3, (512, 6000), np.int8)
    bounds = stats.segment_bounds([2000, 4000])
    C = np.asarray(stats.pop_cross_products(jnp.asarray(G), jnp.asarray(G),
                                            bounds))
    G64 = G.astype(np.int64)
    exact = max(int(np.abs(C[k] - G64[:, lo:hi] @ G64[:, lo:hi].T).max())
                for k, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])))
    log(f"f32 integer cross products vs int64: max|diff| = {exact}")
    assert exact == 0

    # exact int8 products at every contraction length the XLA paths
    # meet (short ones are routed around XLA's s8 GEMM)
    from gauss_jax.ops.window_kernel import _int_gram
    dn = (((2,), (2,)), ((0,), (0,)))
    worst = 0
    rng = np.random.default_rng(2)
    for K in list(range(1, 80)) + [127, 128, 129, 1000]:
        for N in (64, 5):
            a = rng.integers(-2, 3, (2, 64, K), np.int8)
            b = rng.integers(-2, 3, (2, N, K), np.int8)
            got = np.asarray(_int_gram(jnp.asarray(a), jnp.asarray(b), dn))
            ref = np.einsum("wik,wjk->wij", a.astype(np.int64),
                            b.astype(np.int64))
            worst = max(worst, int(np.abs(got - ref).max()))
    log(f"int8 Gram (_int_gram) vs int64, K = 1..79, 127..129, 1000, "
        f"N = 64 and 5: max|diff| = {worst}")
    assert worst == 0
    return t_k, t_x


def _bench_region(pops=None):
    from gauss_jax.utils.benchdata import make_bench_input, make_scaled_panel
    t = time.perf_counter()
    store = make_scaled_panel(N_SNPS, bp_span=BP_SPAN)
    log(f"panel: {store.G.shape[0]} SNPs x {store.G.shape[1]} subjects "
        f"made in {time.perf_counter() - t:.1f}s")
    inp = make_bench_input(store, 0.4)
    pop_wgt = {p: 1.0 / store.desc.num_pops for p in store.desc.pops}
    lo = int(store.index["bp"].min())
    hi = int(store.index["bp"].max())
    return store, inp, pop_wgt, lo, hi


def _window_dz(dev_df, host_df, lo):
    hi = lo + WINDOW_BP - 1
    b = dev_df[(dev_df["bp"] >= lo) & (dev_df["bp"] <= hi)]
    b = b.reset_index(drop=True)
    assert len(b) == len(host_df), (len(b), len(host_df))
    assert (b["rsid"].to_numpy() == host_df["rsid"].to_numpy()).all()
    imp = host_df["type"].to_numpy() == 0
    assert imp.sum() > 0
    z = b["z"].to_numpy()[imp]
    assert np.isfinite(z).all()
    return float(np.abs(z - host_df["z"].to_numpy()[imp]).max()), \
        int(imp.sum())


def phase_main():
    import jax
    from gauss_jax.core import ldkernels
    from gauss_jax.models.genome import GenomeEngine

    store, inp, pop_wgt, lo, hi = _bench_region()
    dev = jax.devices()[0]

    # distmix, cosmopolitan weights
    eng = GenomeEngine(store, snp_bucket=256, device_linalg=True)
    run = eng.prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    t = time.perf_counter()
    res = run.impute_region(lo, hi, window_bp=WINDOW_BP, wing_size=WING_BP)
    t_first = time.perf_counter() - t
    n_imp = int((res["type"] == 0).sum())
    plans, inputs, arrays, _ = run._region_batch(lo, hi, WINDOW_BP, WING_BP)
    Wp, Mp = inputs[2].shape
    Up = inputs[4].shape[1]
    log(f"distmix impute_region: {len(plans)} windows (Wp={Wp}, Mp={Mp}, "
        f"Up={Up}), {n_imp} imputed SNPs; first call {t_first:.1f}s "
        f"(batch build + resident prep + compile)")
    zcol = run.table["z"].to_numpy()
    t = time.perf_counter()
    prep = run._resident_aligned_batch([p[:3] for p in plans], zcol)
    jax.block_until_ready(prep[2])
    t_prep = time.perf_counter() - t
    nbytes = sum(int(a.size) for a in prep[2][:2])
    log(f"resident panel prep (row gather + shift, warm): {t_prep:.3f}s "
        f"for {nbytes / 1e9:.2f} GB of gathered rows")
    del prep
    ts = []
    for _ in range(2):
        t = time.perf_counter()
        res = run.impute_region(lo, hi, window_bp=WINDOW_BP,
                                wing_size=WING_BP)
        ts.append(time.perf_counter() - t)
    n_pipe = 4
    t = time.perf_counter()
    prev = None
    for _ in range(n_pipe):
        h = run.impute_region_async(lo, hi, window_bp=WINDOW_BP,
                                    wing_size=WING_BP)
        if prev is not None:
            prev.result()
        prev = h
    res_p = prev.result()
    t_pipe = (time.perf_counter() - t) / n_pipe
    assert np.array_equal(res_p["z"].to_numpy(), res["z"].to_numpy(),
                          equal_nan=True)
    log(f"distmix steady state: blocking {min(ts):.3f}s/region, pipelined "
        f"{t_pipe:.3f}s/region -> {n_imp / t_pipe:.0f} imputed SNPs/s")

    run_h = GenomeEngine(store, snp_bucket=256).prepare_mix(
        inp, pop_wgt, af1_cutoff=0.01)
    host = run_h.impute_window(lo, lo + WINDOW_BP - 1, WING_BP).table
    dz, n_w = _window_dz(res, host, lo)
    log(f"distmix window 1 vs float64 host path: max|dZ| = {dz:.3e} over "
        f"{n_w} SNPs (bound {DZ_TOL:.0e})")
    assert dz <= DZ_TOL, dz

    # pooled dist on one population
    pop = "CEU"
    t = time.perf_counter()
    run_d = GenomeEngine(store, snp_bucket=256, device_linalg=True
                         ).prepare_homog(inp, pop, af1_cutoff=0.01)
    res_d = run_d.impute_region(lo, hi, window_bp=WINDOW_BP,
                                wing_size=WING_BP)
    t_d = time.perf_counter() - t
    host_d = GenomeEngine(store, snp_bucket=256).prepare_homog(
        inp, pop, af1_cutoff=0.01).impute_window(
        lo, lo + WINDOW_BP - 1, WING_BP).table
    dz_d, n_d = _window_dz(res_d, host_d, lo)
    log(f"dist ({pop}) impute_region {t_d:.1f}s incl. compile; window 1 vs "
        f"float64 host path: max|dZ| = {dz_d:.3e} over {n_d} SNPs")
    assert dz_d <= DZ_TOL, dz_d

    # computeLD, full-precision fetch
    t = time.perf_counter()
    lds = run.ld_region(lo, hi, window_bp=WINDOW_BP, fetch="f32")
    t_ld = time.perf_counter() - t
    ld0 = lds[0]
    typ = run.table["type"].to_numpy()
    bp = run.table["bp"].to_numpy()
    rows = np.flatnonzero((typ == 1) & (bp >= lo) & (bp <= lo + WINDOW_BP - 1))
    assert (run.table["rsid"].to_numpy()[rows]
            == ld0["snplist"]["rsid"].to_numpy()).all()
    G = store.G[np.ix_(run.g_row[rows], run.subj_cols)]
    std = ldkernels.weighted_std(G, run.pop_sizes, run.wgts)
    ref = ldkernels.set_diag(ldkernels.weighted_corr(
        G, G, run.pop_sizes, run.wgts, std_a=std, std_b=std), 1.0)
    dr = float(np.abs(ld0["cormat"] - ref).max())
    log(f"ld_region: {len(lds)} windows in {t_ld:.1f}s incl. compile; "
        f"window 1 ({len(rows)} SNPs) vs computeLD kernels: max|dr| = "
        f"{dr:.3e} (bound {DR_TOL:.0e})")
    assert dr <= DR_TOL, dr
    peak = dev.memory_stats()["peak_bytes_in_use"]
    log(f"peak device memory: {peak / 2**30:.2f} GiB")
    return dz, dz_d, dr


def phase_mesh4():
    import jax
    import __graft_entry__
    from gauss_jax.models.genome import GenomeEngine
    from gauss_jax.parallel import distributed

    __graft_entry__.dryrun_multichip(4)
    store, inp, pop_wgt, lo, hi = _bench_region()
    kw = dict(window_bp=WINDOW_BP, wing_size=WING_BP)
    one = GenomeEngine(store, snp_bucket=256, device_linalg=True
                       ).prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    ref = one.impute_region(lo, hi, **kw)
    mesh = distributed.global_mesh(n_window=1, n_subject=4)
    run = GenomeEngine(store, snp_bucket=256, mesh=mesh).prepare_mix(
        inp, pop_wgt, af1_cutoff=0.01)
    t = time.perf_counter()
    res = run.impute_region(lo, hi, **kw)
    t_first = time.perf_counter() - t
    t = time.perf_counter()
    res = run.impute_region(lo, hi, **kw)
    t_warm = time.perf_counter() - t
    assert (res["rsid"].to_numpy() == ref["rsid"].to_numpy()).all()
    imp = ref["type"].to_numpy() == 0
    dz = float(np.abs(res["z"].to_numpy()[imp]
                      - ref["z"].to_numpy()[imp]).max())
    log(f"1x4 mesh distmix region: first {t_first:.1f}s, warm {t_warm:.3f}s;"
        f" max|dZ| vs one card = {dz:.3e} over {int(imp.sum())} SNPs "
        f"(bound {DZ_TOL:.0e})")
    peaks = [d.memory_stats()["peak_bytes_in_use"] / 2**30
             for d in jax.devices()]
    log("peak memory per card (GiB): "
        + ", ".join(f"{p:.2f}" for p in peaks))
    assert dz <= DZ_TOL, dz


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the four-card engine mesh and its "
                         "one-card comparison")
    args = ap.parse_args()
    n_cards = 4 if args.mesh4 else 1
    phase_device(n_cards)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    import gauss_jax  # noqa: F401  (x64)
    if args.mesh4:
        phase_mesh4()
    else:
        phase_gram()
        gc.collect()
        phase_main()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
