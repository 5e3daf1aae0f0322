"""Device-mesh parallelism for windowed analyses.

The reference has no parallelism at all (single-threaded C++ loops;
SURVEY.md section 2.3) -- this layer is new design.  Two mesh axes:

* ``window``: prediction windows are fully independent given the panel
  (reference proof: each call reloads everything and touches only its
  window's SNPs, src/dist.cpp:129-141) -> pure data parallelism.
* ``subject``: every statistic is a sum over the subject axis, so the
  panel shards by subject chunks (each shard holds an equal slice of
  EVERY population segment) and partial (S, Q, C) statistics combine
  with a single psum over NVLink.  Zero-padded subject columns contribute
  exactly zero to all statistics, so padding for divisibility is exact.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core import stats
from ..ops.window_kernel import (WindowKernelSpec, pad_pop_segments,
                                 window_corr, window_impute, window_qcat)


def make_mesh(n_window: int, n_subject: int,
              devices: Optional[Sequence] = None) -> Mesh:
    devices = list(jax.devices()) if devices is None else list(devices)
    need = n_window * n_subject
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(n_window, n_subject)
    return Mesh(arr, axis_names=("window", "subject"))


def subject_shard_layout(G: np.ndarray, pop_sizes: Sequence[int],
                         n_shards: int) -> Tuple[np.ndarray, Tuple[int, ...], Tuple[int, ...]]:
    """Reorder + pad the subject axis so a contiguous split into
    ``n_shards`` gives every shard an equal slice of every population.

    Returns (G_layout, padded_pop_sizes_global, local_pop_sizes).
    Shard s's block is [for each pop k: segment_k[s*loc_k:(s+1)*loc_k]].
    """
    Gp, padded = pad_pop_segments(G, pop_sizes, multiple=n_shards)
    bounds = stats.segment_bounds(padded)
    locs = tuple(p // n_shards for p in padded)
    blocks = []
    for s in range(n_shards):
        for k in range(len(padded)):
            st = int(bounds[k]) + s * locs[k]
            blocks.append(Gp[..., st:st + locs[k]])
    return np.concatenate(blocks, axis=-1), padded, locs


def subject_valid_layout(pop_sizes: Sequence[int],
                         n_shards: int) -> np.ndarray:
    """Per-column validity mask [S_layout] matching subject_shard_layout:
    1 for real subjects, 0 for divisibility padding (which lands in the
    tail shards of each population segment)."""
    ones = np.ones((1, int(sum(pop_sizes))), dtype=np.float32)
    v, _, _ = subject_shard_layout(ones, pop_sizes, n_shards)
    return v[0]


def build_sharded_region_kernel(spec: WindowKernelSpec, mesh: Mesh):
    """Sharded analog of ops.window_kernel.build_region_kernel: one
    dispatch imputes a whole batch of windows over a (window x subject)
    device mesh.

    Contract: ``spec.pop_sizes`` are the TRUE subject counts,
    ``spec.pop_sizes_padded`` the per-shard (LOCAL) segment widths from
    ``subject_shard_layout``; the panel's subject axis must already be
    in subject_shard_layout order, and W must divide by the window-axis
    size.  Windows are data-parallel (each device scans its W/n_win
    windows, reference independence proof src/dist.cpp:129-141);
    partial sufficient statistics combine with one psum over NVLink.
    Fully-masked padding windows are legal (B11 -> (1+lam)*I).

    Returns (G_layout [R, S_layout] i8, m_idx [W, Mp] i32, u_idx
    [W, Up] i32, Z1, m_mask, u_mask) -> (z [W, Up], info [W, Up]).
    """
    n_sub = mesh.shape["subject"]
    valid = jnp.asarray(subject_valid_layout(spec.pop_sizes, n_sub))
    impute = partial(window_impute, spec=spec, axis_name="subject")

    def fn(G, mi, ui, z1, mm, um, sv):
        W = mi.shape[0]
        B = next(b for b in (4, 2, 1) if W % b == 0)

        def body(_, xs):
            mi1, ui1, z11, mm1, um1 = xs
            Gm = jnp.take(G, mi1, axis=0)
            Gu = jnp.take(G, ui1, axis=0)
            return None, impute(Gm, Gu, z11, mm1, um1, subject_valid=sv)

        xs = tuple(a.reshape((W // B, B) + a.shape[1:])
                   for a in (mi, ui, z1, mm, um))
        _, (z, info) = jax.lax.scan(body, None, xs)
        return (z.reshape((W,) + z.shape[2:]),
                info.reshape((W,) + info.shape[2:]))

    sharded = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(None, "subject"),
                  P("window", None), P("window", None), P("window", None),
                  P("window", None), P("window", None), P("subject")),
        out_specs=(P("window", None), P("window", None)),
    )
    jfn = jax.jit(sharded)

    def wrapper(G_layout, m_idx, u_idx, Z1, m_mask, u_mask):
        return jfn(jnp.asarray(G_layout), jnp.asarray(m_idx),
                   jnp.asarray(u_idx), jnp.asarray(Z1),
                   jnp.asarray(m_mask), jnp.asarray(u_mask), valid)

    return wrapper


def build_sharded_qcat_region_kernel(spec: WindowKernelSpec, mesh: Mesh):
    """Sharded analog of build_qcat_region_kernel (same panel-layout
    contract as build_sharded_region_kernel).  Returns (G_layout, m_idx
    [W, Mp], u_idx [W, Up], Z1, m_mask, u_mask) -> (t_m, chi_m, t_u,
    chi_u, num_eig)."""
    n_sub = mesh.shape["subject"]
    valid = jnp.asarray(subject_valid_layout(spec.pop_sizes, n_sub))
    qcat = partial(window_qcat, spec=spec, axis_name="subject")

    def fn(G, mi, ui, z1, mm, um, sv):
        W = mi.shape[0]
        B = next(b for b in (4, 2, 1) if W % b == 0)

        def body(_, xs):
            mi1, ui1, z11, mm1, um1 = xs
            Gm = jnp.take(G, mi1, axis=0)
            Gu = jnp.take(G, ui1, axis=0)
            return None, qcat(Gm, Gu, z11, mm1, um1, subject_valid=sv)

        xs = tuple(a.reshape((W // B, B) + a.shape[1:])
                   for a in (mi, ui, z1, mm, um))
        _, outs = jax.lax.scan(body, None, xs)
        return tuple(o.reshape((W,) + o.shape[2:]) for o in outs)

    sharded = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(None, "subject"),
                  P("window", None), P("window", None), P("window", None),
                  P("window", None), P("window", None), P("subject")),
        out_specs=(P("window", None),) * 4 + (P("window"),),
    )
    jfn = jax.jit(sharded)

    def wrapper(G_layout, m_idx, u_idx, Z1, m_mask, u_mask):
        return jfn(jnp.asarray(G_layout), jnp.asarray(m_idx),
                   jnp.asarray(u_idx), jnp.asarray(Z1),
                   jnp.asarray(m_mask), jnp.asarray(u_mask), valid)

    return wrapper


def build_sharded_ld_kernel(spec: WindowKernelSpec, mesh: Mesh,
                            fetch: str = "f32"):
    """Sharded analog of build_gather_ld_kernel over a batch of windows
    (same panel-layout contract).  Returns (G_layout, m_idx [W, Mp],
    m_mask [W, Mp]) -> corr [W, Mp, Mp] ("f32") or the packed int16
    lower triangle [W, Mp*(Mp+1)//2] ("i16tri")."""
    from ..ops.window_kernel import pack_tri_i16

    n_sub = mesh.shape["subject"]
    valid = jnp.asarray(subject_valid_layout(spec.pop_sizes, n_sub))

    def fn(G, mi, mm, sv):
        Gm = jnp.take(G, mi, axis=0)
        corr = window_corr(Gm, mm, spec, axis_name="subject",
                           subject_valid=sv)
        return pack_tri_i16(corr) if fetch == "i16tri" else corr

    sharded = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(None, "subject"), P("window", None),
                  P("window", None), P("subject")),
        out_specs=(P("window", None) if fetch == "i16tri"
                   else P("window", None, None)),
    )
    jfn = jax.jit(sharded)

    def wrapper(G_layout, m_idx, m_mask):
        return jfn(jnp.asarray(G_layout), jnp.asarray(m_idx),
                   jnp.asarray(m_mask), valid)

    return wrapper


def build_sharded_pair_stats(local_pop_sizes: Sequence[int], mesh: Mesh):
    """Per-population pair sufficient statistics of an AIM panel over a
    (window x subject) mesh -- the compute core of mesh-parallel
    prep_zmix5 / zmix (reference: the serial all-pairs per-string CalCor
    loop, src/zmix.cpp:157-174 via src/util.cpp:153-169).

    Contract: the panel's subject axis is in ``subject_shard_layout``
    order with per-shard segment widths ``local_pop_sizes``; the SNP row
    axis is zero-padded to a multiple of the window-axis size.  SNP rows
    are data-parallel over ``window`` (each shard computes its row block
    of every Gram against an all-gathered copy of the rows); subject
    slices combine with one psum over ``subject``.  All statistics are
    integer-valued and < 2^24, so the f32 partials and their psum are
    EXACT -- the host f64 combine is bit-identical for any shard count.

    Returns (G_layout [Np, S_layout] i8) -> (C [P, Np, Np], S [Np, P],
    Q [Np, P]) exact-integer f32.
    """
    bounds = stats.segment_bounds(local_pop_sizes)
    nP = len(local_pop_sizes)

    def fn(Xl):
        # Xl [nloc, S_loc] int8: this device's row block x subject slice
        Xg = jax.lax.all_gather(Xl, "window", axis=0, tiled=True)
        Cs, Ss, Qs = [], [], []
        for k in range(nP):
            lo, hi = int(bounds[k]), int(bounds[k + 1])
            a = Xl[:, lo:hi].astype(jnp.float32)
            b = Xg[:, lo:hi].astype(jnp.float32)
            Cs.append(jax.lax.dot_general(
                a, b, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32))
            Ss.append(jnp.sum(a, axis=1))
            Qs.append(jnp.sum(a * a, axis=1))
        C = jax.lax.psum(jnp.stack(Cs), "subject")
        S = jax.lax.psum(jnp.stack(Ss, axis=1), "subject")
        Q = jax.lax.psum(jnp.stack(Qs, axis=1), "subject")
        return C, S, Q

    sharded = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P("window", "subject"),),
        out_specs=(P(None, "window", None), P("window", None),
                   P("window", None)),
    )
    return jax.jit(sharded)


def sharded_region_impute(
    mesh: Mesh,
    G_layout: np.ndarray,      # [R, S_layout] int8 panel (subject-shard layout)
    m_idx: np.ndarray,         # [W, Mp] int32 panel-row indices
    u_idx: np.ndarray,         # [W, Up]
    Z1: np.ndarray,            # [W, Mp]
    m_mask: np.ndarray,
    u_mask: np.ndarray,
    true_pop_sizes: Sequence[int],
    local_pop_sizes: Sequence[int],
    wgts: Optional[Sequence[float]],
    lam: float = 0.1,
    min_abs_eig: float = 1e-5,
):
    """One-shot convenience wrapper over build_sharded_region_kernel."""
    spec = WindowKernelSpec(
        pop_sizes=tuple(int(x) for x in true_pop_sizes),
        pop_sizes_padded=tuple(int(x) for x in local_pop_sizes),
        wgts=tuple(float(x) for x in wgts) if wgts is not None else None,
        lam=lam, min_abs_eig=min_abs_eig,
    )
    fn = build_sharded_region_kernel(spec, mesh)
    return fn(G_layout, m_idx, u_idx, Z1, m_mask, u_mask)


def sharded_window_impute(
    mesh: Mesh,
    Gm: np.ndarray,            # [W, Mp, S_layout] int8 (subject-shard layout)
    Gu: np.ndarray,            # [W, Up, S_layout]
    Z1: np.ndarray,            # [W, Mp]
    m_mask: np.ndarray,
    u_mask: np.ndarray,
    true_pop_sizes: Sequence[int],
    local_pop_sizes: Sequence[int],
    wgts: Optional[Sequence[float]],
    lam: float = 0.1,
    min_abs_eig: float = 1e-5,
):
    """Run the batched window-imputation kernel over a (window, subject)
    mesh.  W must divide by the window-axis size; the subject axis of
    Gm/Gu must already be in subject_shard_layout order."""
    spec = WindowKernelSpec(
        pop_sizes=tuple(int(x) for x in true_pop_sizes),
        pop_sizes_padded=tuple(int(x) for x in local_pop_sizes),
        wgts=tuple(float(x) for x in wgts) if wgts is not None else None,
        lam=lam, min_abs_eig=min_abs_eig,
    )
    n_sub = mesh.shape["subject"]
    valid = subject_valid_layout(true_pop_sizes, n_sub)

    def fn(Gm, Gu, Z1, m_mask, u_mask, subj_valid):
        return window_impute(Gm, Gu, Z1, m_mask, u_mask, spec=spec,
                             axis_name="subject", subject_valid=subj_valid)

    sharded = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P("window", None, "subject"), P("window", None, "subject"),
                  P("window", None), P("window", None), P("window", None),
                  P("subject")),
        out_specs=(P("window", None), P("window", None)),
    )
    jfn = jax.jit(sharded)
    return jfn(jnp.asarray(Gm), jnp.asarray(Gu), jnp.asarray(Z1),
               jnp.asarray(m_mask), jnp.asarray(u_mask), jnp.asarray(valid))
