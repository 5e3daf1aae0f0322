"""afmix / cpw2 / zmix / prep_zmix family tests."""

import numpy as np
import pandas as pd
import pytest

import gauss_jax
from gauss_jax.utils import testing as gtest
from gauss_jax.utils.qp import solve_simplex_qp

import oracle

TRUE_MIX = {"AAA": 0.35, "BBB": 0.25, "CCC": 0.0, "DDD": 0.15, "EEE": 0.25}


@pytest.fixture(scope="module")
def af_input(synpanel, tmp_path_factory):
    d = tmp_path_factory.mktemp("af")
    path = str(d / "afinput.txt")
    gtest.make_af_input(synpanel, path, pop_mix=TRUE_MIX)
    return path


def test_afmix_recovers_mixture(synpanel, af_input):
    res = gauss_jax.afmix(af_input, synpanel.files.index_file,
                          synpanel.files.data_file,
                          synpanel.files.pop_desc_file, interval=8)
    assert set(res.columns) == {"sup.pop", "pop", "wgt"}
    assert (res["wgt"] > 0).all()
    # weights rounded half-up to 3 decimals
    assert np.allclose(res["wgt"] * 1000, np.round(res["wgt"] * 1000))
    w = dict(zip(res["pop"], res["wgt"]))
    for p, true_w in TRUE_MIX.items():
        assert abs(w.get(p, 0.0) - true_w) < 0.12, (p, w)


def test_cpw2_recovers_mixture(synpanel, af_input):
    res = gauss_jax.cpw2(af_input, synpanel.files.index_file,
                         synpanel.files.data_file,
                         synpanel.files.pop_desc_file, interval=8)
    assert set(res.columns) == {"pop", "wgt"}
    w = dict(zip(res["pop"], res["wgt"]))
    for p, true_w in TRUE_MIX.items():
        assert abs(w.get(p, 0.0) - true_w) < 0.15, (p, w)


def test_prep_zmix_pair_structure(synpanel, gwas_input):
    path, truth = gwas_input
    mat = gauss_jax.prep_zmix(path, synpanel.files.index_file,
                              synpanel.files.data_file,
                              synpanel.files.pop_desc_file, interval=7)
    n_meas = len(truth)
    n_sub = len(range(0, n_meas, 7))
    assert mat.shape == (n_sub * (n_sub - 1) // 2, 1 + synpanel.desc.num_pops)
    # first column is the z product of the first subset pair
    z = truth["z"].to_numpy()  # truth is in panel/bp order == map order
    sub = z[::7]
    assert mat[0, 0] == pytest.approx(sub[0] * sub[1], rel=1e-12)
    # correlation columns within [-1, 1]
    finite = np.isfinite(mat[:, 1:])
    assert (np.abs(mat[:, 1:][finite]) <= 1 + 1e-12).all()


def test_prep_zmix_corr_matches_oracle(synpanel, gwas_input):
    path, truth = gwas_input
    mat = gauss_jax.prep_zmix(path, synpanel.files.index_file,
                              synpanel.files.data_file,
                              synpanel.files.pop_desc_file, interval=29)
    # recompute pair (0,1) per-pop correlations from fixture genotypes
    rs2row = {r: i for i, r in enumerate(synpanel.index_df["rsid"])}
    meas_rows = np.array([rs2row[r] for r in truth["rsid"]])
    sub = meas_rows[::29]
    b = np.concatenate([[0], np.cumsum(synpanel.desc.sizes)])
    for k in range(synpanel.desc.num_pops):
        gi = synpanel.genotypes[sub[0], b[k]:b[k + 1]]
        gj = synpanel.genotypes[sub[1], b[k]:b[k + 1]]
        assert mat[0, 1 + k] == pytest.approx(
            oracle.cal_cor_single(gi, gj), rel=1e-10)


def test_prep_zmix_variants_shapes(synpanel, gwas_input):
    path, truth = gwas_input
    P = synpanel.desc.num_pops
    args = (path, synpanel.files.index_file, synpanel.files.data_file,
            synpanel.files.pop_desc_file)
    m2 = gauss_jax.prep_zmix2(*args, interval=13, offset=3)
    n = len(truth)
    n2 = sum(1 for i in range(0, n, 13) if i + 3 < n)
    assert m2.shape == (n2, 1 + P)
    m3 = gauss_jax.prep_zmix3(*args, interval=11, steps=4)
    nsub = len(range(0, n, 11))
    n3 = sum(min(4, nsub - i - 1) for i in range(nsub))
    assert m3.shape == (n3, 1 + P)
    m4 = gauss_jax.prep_zmix4(*args, interval=13, offset=3)
    assert m4.shape[1] == 2 + P
    assert set(np.unique(m4[:, 0])) <= set(range(13))
    m5 = gauss_jax.prep_zmix5(*args, percentile=0.8, interval=2)
    assert m5.shape[1] == 1 + P
    m5s = gauss_jax.prep_zmix5_sup(*args, percentile=0.8, interval=2)
    assert m5s.shape[1] == 1 + len(synpanel.desc.sup_pop_order())


def test_qp_against_scipy():
    from scipy.optimize import minimize
    rng = np.random.default_rng(5)
    for trial in range(10):
        n = rng.integers(3, 12)
        A = rng.standard_normal((30, n))
        D = A.T @ A + 0.05 * np.eye(n)
        d = rng.standard_normal(n)
        w = solve_simplex_qp(D, d)
        assert w.sum() == pytest.approx(1.0, abs=1e-9)
        assert (w >= -1e-12).all() and (w <= 1 + 1e-12).all()
        obj = lambda v: 0.5 * v @ D @ v - d @ v
        ref = minimize(obj, np.full(n, 1 / n), method="SLSQP",
                       bounds=[(0, 1)] * n,
                       constraints=[{"type": "eq",
                                     "fun": lambda v: v.sum() - 1}],
                       options={"ftol": 1e-14, "maxiter": 500})
        assert obj(w) <= obj(ref.x) + 1e-9


def test_zmix_runs_and_recovers_signal(synpanel, tmp_path):
    """Generate z with cov = sum_k w_k R_k (the zmix model) and check the
    QP recovers the dominant populations."""
    rng = np.random.default_rng(17)
    desc = synpanel.desc
    n_all = len(synpanel.index_df)
    w_true = np.array([0.6, 0.0, 0.0, 0.0, 0.4])
    b = np.concatenate([[0], np.cumsum(desc.sizes)])
    R = np.zeros((n_all, n_all))
    for k in range(desc.num_pops):
        if w_true[k] == 0:
            continue
        Rk = oracle.pooled_corr_matrix(
            synpanel.genotypes[:, b[k]:b[k + 1]],
            synpanel.genotypes[:, b[k]:b[k + 1]])
        # monomorphic SNPs in a population give 0/0; harmless for the
        # generator, so zero them and keep a unit diagonal
        Rk = np.nan_to_num(Rk)
        np.fill_diagonal(Rk, 1.0)
        R += w_true[k] * Rk
    ww, vv = np.linalg.eigh(R)
    R = (vv * np.maximum(ww, 1e-3)) @ vv.T
    L = np.linalg.cholesky(R)
    z = L @ rng.standard_normal(n_all)

    path = tmp_path / "zin.txt"
    with open(path, "w") as fh:
        fh.write("rsid chr bp a1 a2 z\n")
        for i, r in synpanel.index_df.iterrows():
            fh.write(f"{r.rsid} {r.chr} {r.bp} {r.a1} {r.a2} {z[i]:.8f}\n")

    res = gauss_jax.zmix(str(path), synpanel.files.index_file,
                         synpanel.files.data_file,
                         synpanel.files.pop_desc_file,
                         percentile=0.5, interval=1)
    assert list(res.columns) == ["Population", "SuperPopulation", "Weight"]
    assert res["Weight"].sum() == pytest.approx(1.0, abs=1e-6)
    w = dict(zip(res["Population"], res["Weight"]))
    # dominant populations should get the bulk of the weight
    assert w["AAA"] + w["EEE"] > 0.5

    res_sup = gauss_jax.zmix(str(path), synpanel.files.index_file,
                             synpanel.files.data_file,
                             synpanel.files.pop_desc_file,
                             percentile=0.5, interval=1,
                             level="superpopulation")
    assert list(res_sup.columns) == ["SuperPopulation", "Weight"]
    assert len(res_sup) == len(desc.sup_pop_order())


# ---------------------------------------------------------------------------
# PanelStore-resident ancestry: exact parity with the per-call bgzf path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def anc_store(synpanel):
    from gauss_jax.models.genome import PanelStore
    return PanelStore.from_bgzf(synpanel.files)


def test_afmix_cpw2_store_parity(synpanel, af_input, anc_store):
    from gauss_jax.io import readers
    from gauss_jax.models import ancestry
    inp = readers.read_input_af(af_input)
    for file_fn, store_fn in ((gauss_jax.afmix, ancestry.afmix_store),
                              (gauss_jax.cpw2, ancestry.cpw2_store)):
        ref = file_fn(af_input, synpanel.files.index_file,
                      synpanel.files.data_file,
                      synpanel.files.pop_desc_file, interval=25)
        got = store_fn(anc_store, inp, interval=25)
        assert list(got["pop"]) == list(ref["pop"])
        np.testing.assert_allclose(got["wgt"], ref["wgt"], rtol=0, atol=0)


def test_prep_zmix5_and_zmix_store_parity(synpanel, gwas_input, anc_store):
    from gauss_jax.io import readers
    from gauss_jax.models import ancestry
    path, _ = gwas_input
    inp = readers.read_input_z(path, all_snps=True)

    ref = gauss_jax.prep_zmix5(path, synpanel.files.index_file,
                               synpanel.files.data_file,
                               synpanel.files.pop_desc_file,
                               percentile=0.5, interval=2)
    got = ancestry.prep_zmix5_store(anc_store, inp, percentile=0.5,
                                    interval=2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=0)

    refs = gauss_jax.prep_zmix5_sup(path, synpanel.files.index_file,
                                    synpanel.files.data_file,
                                    synpanel.files.pop_desc_file,
                                    percentile=0.5, interval=2)
    gots = ancestry.prep_zmix5_store(anc_store, inp, percentile=0.5,
                                     interval=2, sup_level=True)
    np.testing.assert_allclose(gots, refs, rtol=0, atol=0)

    refz = gauss_jax.zmix(path, synpanel.files.index_file,
                          synpanel.files.data_file,
                          synpanel.files.pop_desc_file,
                          percentile=0.5, interval=2)
    gotz = ancestry.zmix_store(anc_store, inp, percentile=0.5, interval=2)
    np.testing.assert_allclose(gotz["Weight"], refz["Weight"],
                               rtol=0, atol=0)


def test_prep_zmix5_mesh_matches_single_device(gwas_input, anc_store):
    """Mesh-sharded pair correlations (AIM rows over the window axis,
    subjects psum'd) are bit-identical to the single-device path: all
    sufficient statistics are exact integers at any shard count."""
    from gauss_jax.io import readers
    from gauss_jax.models import ancestry
    from gauss_jax.parallel.mesh import make_mesh
    path, _ = gwas_input
    inp = readers.read_input_z(path, all_snps=True)
    mesh = make_mesh(2, 4)

    for sup in (False, True):
        one = ancestry.prep_zmix5_store(anc_store, inp, percentile=0.5,
                                        interval=2, sup_level=sup)
        got = ancestry.prep_zmix5_store(anc_store, inp, percentile=0.5,
                                        interval=2, sup_level=sup,
                                        mesh=mesh)
        np.testing.assert_allclose(got, one, rtol=0, atol=0)

    z1 = ancestry.zmix_store(anc_store, inp, percentile=0.5, interval=2)
    zm = ancestry.zmix_store(anc_store, inp, percentile=0.5, interval=2,
                             mesh=mesh)
    np.testing.assert_allclose(zm["Weight"], z1["Weight"], rtol=0, atol=0)


def test_engine_ancestry_methods(synpanel, af_input, anc_store):
    """GenomeEngine delegates: one store serves afmix AND zmix without a
    second decode."""
    from gauss_jax.io import readers
    from gauss_jax.models.genome import GenomeEngine
    eng = GenomeEngine(anc_store)
    inp = readers.read_input_af(af_input)
    res = eng.afmix(inp, interval=25)
    assert (res["wgt"] > 0).all()
    res2 = eng.cpw2(inp, interval=25)
    assert (res2["wgt"] > 0).all()


# ---------------------------------------------------------------------------
# Adversarial QP validation: exact support-enumeration oracle
# ---------------------------------------------------------------------------

def _simplex_qp_oracle(D, d, eps=1e-9):
    """Exact minimizer of 1/2 w'Dw - d'w on the simplex by enumerating
    supports: the optimum's free set solves the equality KKT system, so
    the best primal-feasible candidate over all 2^n - 1 supports is the
    global optimum (exhaustive; n <= ~12)."""
    from itertools import combinations
    n = len(d)
    best_w, best_obj = None, np.inf
    obj = lambda w: 0.5 * w @ D @ w - d @ w
    for k in range(1, n + 1):
        for S in combinations(range(n), k):
            idx = np.asarray(S)
            K = np.zeros((k + 1, k + 1))
            K[:k, :k] = D[np.ix_(idx, idx)]
            K[:k, k] = -1.0
            K[k, :k] = 1.0
            rhs = np.concatenate([d[idx], [1.0]])
            try:
                sol, *_ = np.linalg.lstsq(K, rhs, rcond=None)
            except np.linalg.LinAlgError:
                continue
            w = np.zeros(n)
            w[idx] = sol[:k]
            if (w >= -eps).all() and abs(w.sum() - 1) < 1e-7:
                w = np.clip(w, 0, None)
                w = w / w.sum()
                o = obj(w)
                if o < best_obj:
                    best_obj, best_w = o, w
    return best_w, best_obj


def test_qp_against_enumeration_oracle():
    """Randomized adversarial cross-check incl. near-singular and
    duplicate-column D (rank-deficient X'X happens when two panel
    populations are nearly identical; reference quadprog handles it via
    its own ridge conventions, we must not silently diverge)."""
    rng = np.random.default_rng(23)
    obj = lambda D, d, w: 0.5 * w @ D @ w - d @ w
    cases = []
    for trial in range(30):
        n = int(rng.integers(3, 9))
        rows = int(rng.integers(n + 1, 40))
        A = rng.standard_normal((rows, n))
        if trial % 3 == 1:
            A[:, -1] = A[:, 0] + 1e-6 * rng.standard_normal(rows)  # dup col
        D = A.T @ A + 1e-8 * np.eye(n)
        d = A.T @ rng.standard_normal(rows)
        cases.append((D, d))
    # hand-built degenerate cases
    x = np.array([1.0, 2.0, 3.0, 4.0])
    cases.append((np.outer(x, x) + 1e-7 * np.eye(4), x.copy()))
    cases.append((np.eye(3) * 1e-10 + 1e-10, np.zeros(3)))

    for D, d in cases:
        w = solve_simplex_qp(D, d)
        assert w.sum() == pytest.approx(1.0, abs=1e-8)
        assert (w >= -1e-10).all()
        w_ref, obj_ref = _simplex_qp_oracle(D, d)
        assert w_ref is not None
        scale = max(1.0, abs(obj_ref))
        assert obj(D, d, w) <= obj_ref + 1e-7 * scale, (
            f"solver obj {obj(D, d, w)} > oracle obj {obj_ref}")


def _meas_rows(synpanel, truth):
    rs2row = {r: i for i, r in enumerate(synpanel.index_df["rsid"])}
    return np.array([rs2row[r] for r in truth["rsid"]])


def _oracle_pair_rows(synpanel, rows_i, rows_j, z_i, z_j):
    """Scalar oracle for one batch of (i, j) pairs: col0 = z_i*z_j,
    cols 1..P = per-pop Pearson r from the fixture genotypes
    (per-pop-string CalCor, reference src/util.cpp:153-169)."""
    b = np.concatenate([[0], np.cumsum(synpanel.desc.sizes)])
    P = synpanel.desc.num_pops
    out = np.empty((len(rows_i), 1 + P))
    out[:, 0] = z_i * z_j
    for r, (ri, rj) in enumerate(zip(rows_i, rows_j)):
        for k in range(P):
            gi = synpanel.genotypes[ri, b[k]:b[k + 1]]
            gj = synpanel.genotypes[rj, b[k]:b[k + 1]]
            out[r, 1 + k] = oracle.cal_cor_single(gi, gj)
    return out


def test_prep_zmix2_values(synpanel, gwas_input):
    """Offset-pairing VALUES (reference loop src/zmix.cpp:737-786:
    i += interval over ALL measured SNPs, pair (i, i+offset))."""
    path, truth = gwas_input
    interval, offset = 13, 3
    mat = gauss_jax.prep_zmix2(path, synpanel.files.index_file,
                               synpanel.files.data_file,
                               synpanel.files.pop_desc_file,
                               interval=interval, offset=offset)
    rows = _meas_rows(synpanel, truth)
    z = truth["z"].to_numpy()
    n = len(rows)
    ii = np.array([i for i in range(0, n, interval) if i + offset < n])
    want = _oracle_pair_rows(synpanel, rows[ii], rows[ii + offset],
                             z[ii], z[ii + offset])
    np.testing.assert_allclose(mat, want, rtol=1e-10, atol=1e-12)


def test_prep_zmix3_values(synpanel, gwas_input):
    """Steps-pairing VALUES (reference loop src/zmix.cpp:603-633:
    strided subset, each SNP x its next ``steps`` subset neighbours,
    in (i, then j) order)."""
    path, truth = gwas_input
    interval, steps = 11, 4
    mat = gauss_jax.prep_zmix3(path, synpanel.files.index_file,
                               synpanel.files.data_file,
                               synpanel.files.pop_desc_file,
                               interval=interval, steps=steps)
    rows = _meas_rows(synpanel, truth)[::interval]
    z = truth["z"].to_numpy()[::interval]
    nsub = len(rows)
    pi, pj = [], []
    for i in range(nsub):
        for j in range(i + 1, min(i + 1 + steps, nsub)):
            pi.append(i)
            pj.append(j)
    pi, pj = np.asarray(pi), np.asarray(pj)
    want = _oracle_pair_rows(synpanel, rows[pi], rows[pj], z[pi], z[pj])
    np.testing.assert_allclose(mat, want, rtol=1e-10, atol=1e-12)


def test_prep_zmix4_values(synpanel, gwas_input):
    """Interleaved offset-pairing VALUES incl. the h-index column
    (reference loop src/zmix.cpp:457-493: for h in 0..interval-1,
    i = h, h+interval, ...; row = [h, z_i z_j, r_pop...])."""
    path, truth = gwas_input
    interval, offset = 13, 3
    mat = gauss_jax.prep_zmix4(path, synpanel.files.index_file,
                               synpanel.files.data_file,
                               synpanel.files.pop_desc_file,
                               interval=interval, offset=offset)
    rows = _meas_rows(synpanel, truth)
    z = truth["z"].to_numpy()
    n = len(rows)
    hs, ii = [], []
    for h in range(interval):
        for i in range(h, n, interval):
            if i + offset < n:
                hs.append(h)
                ii.append(i)
    hs, ii = np.asarray(hs), np.asarray(ii)
    want = _oracle_pair_rows(synpanel, rows[ii], rows[ii + offset],
                             z[ii], z[ii + offset])
    np.testing.assert_allclose(mat[:, 0], hs.astype(float))
    np.testing.assert_allclose(mat[:, 1:], want, rtol=1e-10, atol=1e-12)
