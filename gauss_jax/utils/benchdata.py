"""Scaled synthetic panel generation for benchmarking.

Builds a 33KG-shaped panel (29 populations, 32,953 subjects -- the real
reference panel's shape, vignettes/ref_33KG.Rmd:24-52) with AR(1) LD
structure, directly as a PanelStore (no bgzf roundtrip; that layer has
its own tests).  Cached on disk so repeated bench runs are instant.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd

from ..io.readers import PopDesc
from ..models.genome import PanelStore
from scipy.special import ndtri

# 33KG population structure (29 pops, 32,953 subjects across 5 super-pops)
POPS_33KG: List[Tuple[str, int, str]] = [
    ("ACB", 164, "AFR"), ("ASW", 162, "AFR"), ("BEB", 86, "SAS"),
    ("CCE", 1538, "EAS"), ("CCS", 2004, "EAS"), ("CDX", 93, "EAS"),
    ("CEU", 6360, "EUR"), ("CHB", 103, "EAS"), ("CHS", 105, "EAS"),
    ("CLM", 94, "AMR"), ("ESN", 99, "AFR"), ("FIN", 3529, "EUR"),
    ("GBR", 2020, "EUR"), ("GIH", 103, "SAS"), ("GWD", 113, "AFR"),
    ("IBS", 1309, "EUR"), ("ITU", 102, "SAS"), ("JPT", 2504, "EAS"),
    ("KHV", 99, "EAS"), ("LWK", 99, "AFR"), ("MSL", 85, "AFR"),
    ("MXL", 64, "AMR"), ("ORK", 5772, "EUR"), ("PEL", 85, "AMR"),
    ("PJL", 96, "SAS"), ("PUR", 104, "AMR"), ("STU", 102, "SAS"),
    ("TSI", 3011, "EUR"), ("YRI", 3148, "AFR"),
]


def make_scaled_panel(
    n_snps: int,
    pops: Optional[List[Tuple[str, int, str]]] = None,
    chrom: int = 22,
    bp_start: int = 16_000_000,
    bp_span: int = 16_000_000,
    rho: float = 0.94,
    seed: int = 123,
    verbose: bool = False,
) -> PanelStore:
    pops = POPS_33KG if pops is None else pops
    desc = PopDesc(pops=[p[0] for p in pops],
                   sizes=np.array([p[1] for p in pops], dtype=np.int64),
                   sup_pops=[p[2] for p in pops])
    S = desc.total_subjects
    rng = np.random.default_rng(seed)

    # per-pop AF profiles around shared base AFs (super-pops drift together)
    base_af = rng.uniform(0.05, 0.95, size=n_snps).astype(np.float32)
    sup_order = desc.sup_pop_order()
    sup_shift = {sp: rng.normal(0, 0.08, size=n_snps).astype(np.float32)
                 for sp in sup_order}
    pop_af = np.stack([
        np.clip(base_af + sup_shift[desc.sup_pops[k]]
                + rng.normal(0, 0.04, size=n_snps).astype(np.float32),
                0.02, 0.98)
        for k in range(desc.num_pops)], axis=1)  # [n_snps, P]
    thresh = ndtri(pop_af.astype(np.float64)).astype(np.float32)
    bounds = np.concatenate([[0], np.cumsum(desc.sizes)])
    subj_pop = np.repeat(np.arange(desc.num_pops), desc.sizes)
    G = _ar1_genotypes(thresh, subj_pop, np.float32(rho), seed,
                       verbose=verbose)

    af = np.stack([G[:, bounds[k]:bounds[k + 1]].mean(axis=1) / 2.0
                   for k in range(desc.num_pops)], axis=1)

    step = max(1, bp_span // n_snps)
    index = pd.DataFrame({
        "rsid": [f"rs{200000 + i}" for i in range(n_snps)],
        "chr": np.full(n_snps, chrom, dtype=np.int32),
        "bp": bp_start + step * np.arange(n_snps, dtype=np.int64),
        "a1": np.resize(np.array(["A", "C"]), n_snps),
        "a2": np.resize(np.array(["G", "T"]), n_snps),
        "af1ref": af.mean(axis=1),
        "fpos": np.arange(n_snps, dtype=np.int64),  # store row ids
    })
    return PanelStore(index=index, G=G, af=af, desc=desc)


def _ar1_genotypes(thresh: np.ndarray, subj_pop: np.ndarray,
                   rho: np.float32, seed: int, chunk: int = 4096,
                   verbose: bool = False) -> np.ndarray:
    """int8 dosages [n_snps, S]: two AR(1) latent haplotypes per subject
    walk along the SNPs (x <- rho x + sqrt(1 - rho^2) e), each
    thresholded at its population's per-SNP quantile.  Generated on the
    default JAX device, ``chunk`` SNPs per dispatch."""
    import jax
    import jax.numpy as jnp

    n_snps = thresh.shape[0]
    S = len(subj_pop)
    c = np.float32(np.sqrt(1 - rho * rho))
    sp = jnp.asarray(subj_pop, dtype=jnp.int32)

    @jax.jit
    def run(x, keys, th):
        def step(x, kt):
            k, t = kt
            x = rho * x + c * jax.random.normal(k, (2, S), jnp.float32)
            return x, jnp.sum(x < t[sp][None, :], axis=0, dtype=jnp.int8)
        return jax.lax.scan(step, x, (keys, th))

    k0, key = jax.random.split(jax.random.PRNGKey(seed))
    x = jax.random.normal(k0, (2, S), jnp.float32)
    G = np.empty((n_snps, S), dtype=np.int8)
    for lo in range(0, n_snps, chunk):
        hi = min(lo + chunk, n_snps)
        keys = jax.random.split(jax.random.fold_in(key, lo), hi - lo)
        x, g = run(x, keys, jnp.asarray(thresh[lo:hi]))
        G[lo:hi] = np.asarray(g)
        if verbose:
            print(f"  genotypes {hi}/{n_snps}", flush=True)
    return G


def cached_panel(cache_dir: str, n_snps: int, verbose: bool = False,
                 **kw) -> PanelStore:
    span = kw.get("bp_span")
    suffix = f"panel_{n_snps}" + (f"_{span}" if span else "")
    tag = os.path.join(cache_dir, suffix)
    if os.path.isdir(tag):
        try:
            return PanelStore.load(tag)
        except Exception:
            pass
    store = make_scaled_panel(n_snps, verbose=verbose, **kw)
    try:
        store.save(tag)
    except Exception:
        pass
    return store


def make_bench_input(store: PanelStore, measured_frac: float = 0.4,
                     seed: int = 7) -> pd.DataFrame:
    """Measured-SNP Z table in the engine's expected format."""
    rng = np.random.default_rng(seed)
    n = len(store.index)
    rows = np.sort(rng.choice(n, size=int(n * measured_frac), replace=False))
    idx = store.index.iloc[rows]
    return pd.DataFrame({
        "rsid": idx["rsid"].to_numpy(),
        "chr": idx["chr"].to_numpy(),
        "bp": idx["bp"].to_numpy(),
        "a1": idx["a1"].to_numpy(),
        "a2": idx["a2"].to_numpy(),
        "z": rng.standard_normal(len(rows)) * 1.5,
        "info": 1.0,
        "type": np.int8(2),
    })
