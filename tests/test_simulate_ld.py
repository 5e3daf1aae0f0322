"""simulateLD coverage (reference: src/simulateLD.cpp:32-271).

Seed-pinned: the reference seeds std::mt19937 from std::random_device
(src/simulateLD.cpp:134-138) so bit-level parity with the reference
binary is impossible; instead these tests pin gauss_jax's documented
sampling contract and check the correlation math against an
independent numpy Pearson oracle on the reconstructed draw.
"""

import numpy as np
import pandas as pd
import pytest

import gauss_jax
from gauss_jax import cli
from gauss_jax.io import readers
from gauss_jax.models.ld import compute_ld, simulate_ld

POP_WGT = pd.DataFrame({"pop": ["AAA", "CCC", "EEE"],
                        "wgt": [0.37, 0.402, 0.228]})
SIM_SIZE = 500
SEED = 123


@pytest.fixture(scope="module")
def region(synpanel):
    bp = synpanel.index_df["bp"]
    return int(bp.min()), int(bp.max())


@pytest.fixture(scope="module")
def sim_result(synpanel, gwas_input, region):
    path, _ = gwas_input
    lo, hi = region
    return simulate_ld(22, lo, hi, POP_WGT, SIM_SIZE, path,
                       synpanel.files.index_file,
                       synpanel.files.data_file,
                       synpanel.files.pop_desc_file, seed=SEED), (lo, hi)


def _reconstruct_sim(synpanel, snplist):
    """Replay the documented sampling contract: per selected pop (in
    pop-desc order), draw floor(wgt*sim_size) subject columns with
    replacement via default_rng(seed).integers -- the (int) truncation
    of src/simulateLD.cpp:141."""
    desc = readers.read_pop_desc(synpanel.files.pop_desc_file)
    rows = synpanel.index_df.set_index("bp").index.get_indexer(
        snplist["bp"].to_numpy())
    assert (rows >= 0).all()
    G = synpanel.genotypes[rows]
    bounds = np.concatenate([[0], np.cumsum(desc.sizes)])
    wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    rng = np.random.default_rng(SEED)
    cols = []
    counts = {}
    for k, pop in enumerate(desc.pops):
        if pop not in wgt:
            continue
        n_sim = int(wgt[pop] * SIM_SIZE)
        counts[pop] = n_sim
        if n_sim <= 0:
            continue
        seg = G[:, bounds[k]:bounds[k + 1]]
        draw = rng.integers(0, seg.shape[1], size=n_sim)
        cols.append(seg[:, draw])
    return np.concatenate(cols, axis=1).astype(np.float64), counts


def test_simulate_ld_sample_counts(sim_result, synpanel):
    """(int) truncation of per-pop draw counts, src/simulateLD.cpp:141.
    The truncation (not rounding) case: 0.37*SIM_SIZE*1.07 style
    fractional products drop their fraction -- checked explicitly via
    a weight whose product has a genuine fractional part."""
    (res, _) = sim_result
    sim, counts = _reconstruct_sim(synpanel, res["snplist"])
    assert counts == {"AAA": int(0.37 * SIM_SIZE),
                      "CCC": int(0.402 * SIM_SIZE),
                      "EEE": int(0.228 * SIM_SIZE)}
    assert sim.shape[1] == sum(counts.values())
    # truncation, not rounding (0.333 * 500 = 166.5 -> 166)
    assert int(0.333 * SIM_SIZE) == 166


def test_simulate_ld_matches_pearson_oracle(sim_result, synpanel):
    """cormat == numpy Pearson correlation of the drawn matrix
    (scalar CalCor oracle, src/simulateLD.cpp:257-271)."""
    (res, _) = sim_result
    sim, _ = _reconstruct_sim(synpanel, res["snplist"])
    want = np.corrcoef(sim)
    np.testing.assert_allclose(res["cormat"], want, atol=1e-10)
    assert np.allclose(np.diag(res["cormat"]), 1.0)
    assert np.allclose(res["cormat"], res["cormat"].T)


def test_simulate_ld_approximates_weighted_ld(synpanel, gwas_input,
                                              region):
    """Statistical sanity: a large simulated cohort's Pearson LD tracks
    the ancestry-weighted computeLD estimate on the same window."""
    path, _ = gwas_input
    lo, hi = region
    sim = simulate_ld(22, lo, hi, POP_WGT, 20_000, path,
                      synpanel.files.index_file, synpanel.files.data_file,
                      synpanel.files.pop_desc_file, seed=7)
    ld = compute_ld(22, lo, hi, POP_WGT, path,
                    synpanel.files.index_file, synpanel.files.data_file,
                    synpanel.files.pop_desc_file)
    iu = np.triu_indices(len(sim["cormat"]), 1)
    a, b = sim["cormat"][iu], ld["cormat"][iu]
    r = np.corrcoef(a, b)[0, 1]
    # the two estimators differ by design -- the simulated cohort's
    # pooled Pearson r includes between-pop AF structure that the
    # within-pop weighted estimator removes -- so this is a sanity
    # band, not an equality
    assert r > 0.8, r
    assert np.abs(a - b).mean() < 0.1


def test_simulate_ld_zero_weight_pop_dropped(synpanel, gwas_input,
                                             region):
    """A pop whose floor(wgt*sim_size) is 0 contributes no columns."""
    path, _ = gwas_input
    lo, hi = region
    wgt = pd.DataFrame({"pop": ["AAA", "CCC"], "wgt": [0.999, 0.0008]})
    res = simulate_ld(22, lo, hi, wgt, 100, path,
                      synpanel.files.index_file, synpanel.files.data_file,
                      synpanel.files.pop_desc_file, seed=3)
    # only AAA's floor(0.999*100)=99 columns exist; SNPs whose 99-column
    # draw happens to be monomorphic divide by zero variance and emit
    # NaN, exactly like the reference's CalCor (src/simulateLD.cpp:268;
    # README deviations: NaN propagation is kept, not masked)
    cor = res["cormat"]
    bad = ~np.isfinite(cor)
    if bad.any():
        mono = np.flatnonzero(bad.all(axis=1) | (bad.sum(axis=1) > 0))
        # every non-finite entry lies on a monomorphic row/col
        rowbad = np.unique(np.concatenate(np.nonzero(bad)))
        assert set(rowbad) <= set(mono)
    # off the monomorphic rows the matrix is a valid correlation
    ok = np.flatnonzero(np.isfinite(cor).all(axis=1))
    sub = cor[np.ix_(ok, ok)]
    assert (np.abs(sub) <= 1 + 1e-12).all()


def test_cli_simulate_ld_round_trip(synpanel, gwas_input, region,
                                    tmp_path):
    path, _ = gwas_input
    lo, hi = region
    wgt_file = tmp_path / "wgt.tsv"
    POP_WGT.to_csv(wgt_file, sep="\t", index=False)
    out = tmp_path / "snps.tsv"
    cormat_out = tmp_path / "cormat.tsv"
    cli.main(["simulateLD", "--chr", "22", "--start-bp", str(lo),
              "--end-bp", str(hi),
              "--sim-size", str(SIM_SIZE), "--seed", str(SEED),
              "--pop-wgt-file", str(wgt_file), "--input-file", path]
             + ["--reference-index-file", synpanel.files.index_file,
                "--reference-data-file", synpanel.files.data_file,
                "--reference-pop-desc-file", synpanel.files.pop_desc_file]
             + ["-o", str(out), "--cormat-out", str(cormat_out)])
    snps = pd.read_csv(out, sep="\t")
    mat = np.loadtxt(cormat_out)
    assert len(snps) == len(mat)
    # same seed through the API reproduces the CLI output
    api = simulate_ld(22, lo, hi, POP_WGT, SIM_SIZE, path,
                      synpanel.files.index_file, synpanel.files.data_file,
                      synpanel.files.pop_desc_file, seed=SEED)
    np.testing.assert_allclose(mat, api["cormat"], atol=1e-6)
