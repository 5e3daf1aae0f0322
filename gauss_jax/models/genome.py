"""Genome-scale windowed imputation engine.

The reference scales to a genome by the USER calling dist/distmix once
per window, re-reading the panel every call (SURVEY.md section 2.3).
This engine is the accelerator-resident replacement:

* the panel region is decoded ONCE into an int8 dosage matrix
  (PanelStore) that is reused by every window;
* windows are scheduled over bucket-padded static shapes so XLA
  compiles a handful of kernels for an entire chromosome;
* per-window correlation blocks run on the accelerator (exact integer
  f32 stats + f64 combines); the dense solves run either on the host in
  float64 (parity mode, default) or fused on-device in float32
  (throughput mode).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from ..config import PanelFiles, Settings, DEFAULT_SETTINGS
from ..core import linalg, stats, variants
from ..io import readers
from ..io.panel import PanelReader, read_panel_index
from ..ops.window_kernel import (WindowKernelSpec, build_gather_ld_kernel,
                                 build_gather_window_kernel,
                                 build_qcat_region_kernel,
                                 build_region_kernel,
                                 build_resident_region_kernel,
                                 build_window_kernel, pad_pop_segments,
                                 prepare_resident_panel, unpack_tri_i16)
from ..utils.special import pchisq_upper, pnorm_two_sided

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# PanelStore: one-shot decoded panel region
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PanelStore:
    """Columnar decoded panel: the HBM-side format of SURVEY.md section 7."""

    index: pd.DataFrame            # rsid chr bp a1 a2 af1ref fpos
    G: np.ndarray                  # int8 [n_snps, S_all] all populations
    af: np.ndarray                 # float64 [n_snps, P]
    desc: readers.PopDesc

    @classmethod
    def from_bgzf(cls, panel: PanelFiles, chrom: int = 0,
                  start_bp: Optional[int] = None,
                  end_bp: Optional[int] = None) -> "PanelStore":
        desc = readers.read_pop_desc(panel.pop_desc_file)
        idx = read_panel_index(panel.index_file, chrom=chrom,
                               start_bp=start_bp, end_bp=end_bp)
        reader = PanelReader(panel.data_file, desc)
        dec = reader.decode_rows(idx["fpos"].to_numpy())
        return cls(index=idx, G=dec.G, af=dec.af, desc=desc)

    @classmethod
    def from_arrays(cls, index: pd.DataFrame, G: np.ndarray,
                    af: np.ndarray, desc: readers.PopDesc) -> "PanelStore":
        return cls(index=index, G=G, af=af, desc=desc)

    def save(self, dir_path: str) -> None:
        os.makedirs(dir_path, exist_ok=True)
        np.save(os.path.join(dir_path, "G.npy"), self.G)
        np.save(os.path.join(dir_path, "af.npy"), self.af)
        self.index.to_parquet(os.path.join(dir_path, "index.parquet"))
        with open(os.path.join(dir_path, "pop_desc.txt"), "w") as fh:
            fh.write("Population_Abbreviation\tN\tSuper_Population\n")
            for p, m, sp in zip(self.desc.pops, self.desc.sizes,
                                self.desc.sup_pops):
                fh.write(f"{p}\t{m}\t{sp}\n")

    @classmethod
    def load(cls, dir_path: str) -> "PanelStore":
        G = np.load(os.path.join(dir_path, "G.npy"), mmap_mode="r")
        af = np.load(os.path.join(dir_path, "af.npy"))
        index = pd.read_parquet(os.path.join(dir_path, "index.parquet"))
        desc = readers.read_pop_desc(os.path.join(dir_path, "pop_desc.txt"))
        return cls(index=index, G=np.asarray(G), af=af, desc=desc)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class WindowResult:
    table: pd.DataFrame            # output rows for the prediction window
    n_measured: int
    n_unmeasured: int


class GenomeEngine:
    """Windowed distmix/dist over a PanelStore."""

    def __init__(self, store: PanelStore,
                 settings: Settings = DEFAULT_SETTINGS,
                 snp_bucket: int = 256,
                 device_linalg: bool = False,
                 window_bucket: int = 4,
                 stats: str = "pallas",
                 mesh=None,
                 region_mode: str = "auto"):
        """``mesh``: an optional jax.sharding.Mesh with axes
        ("window", "subject").  When set, the device path runs sharded:
        the panel lives subject-sharded across the mesh's ``subject``
        axis (partial sufficient statistics psum over NVLink) and window
        batches split over the ``window`` axis (pure data parallelism;
        windows are independent, reference src/dist.cpp:129-141).
        Implies device_linalg."""
        self.store = store
        self.settings = settings
        self.snp_bucket = snp_bucket
        self.window_bucket = window_bucket
        self.stats = stats             # "pallas" | "int8" | "centered"
        self.mesh = mesh
        if mesh is not None:
            if set(mesh.axis_names) != {"window", "subject"}:
                raise ValueError("engine mesh must have axes "
                                 "('window', 'subject'), got "
                                 f"{mesh.axis_names}")
            device_linalg = True
        self.device_linalg = device_linalg
        if region_mode not in ("auto", "resident", "gather"):
            raise ValueError(f"unknown region_mode '{region_mode}'")
        self.region_mode = region_mode
        self._corr_fns: Dict = {}
        self._fused_fns: Dict = {}

    def _use_resident(self, wgts) -> bool:
        """Gather-free resident region kernel eligibility: unsharded,
        Pallas stats (see build_resident_region_kernel; wgts=None takes
        the pooled single-segment mode of _resident_block_builder).
        "auto" takes it on the GPU, where its Gram is the Pallas kernel;
        "resident" forces it elsewhere (parity tests)."""
        if self.region_mode == "gather":
            return False
        if self.mesh is not None or self.stats != "pallas":
            return False
        return (self.region_mode == "resident"
                or jax.default_backend() == "gpu")

    # -- selection --------------------------------------------------------
    def _select(self, pop_flags: np.ndarray):
        sel = np.flatnonzero(pop_flags != 0)
        bounds = stats.segment_bounds(self.store.desc.sizes)
        cols = np.concatenate([np.arange(bounds[k], bounds[k + 1])
                               for k in sel])
        sizes = tuple(int(self.store.desc.sizes[k]) for k in sel)
        return sel, cols, sizes

    def prepare_mix(self, input_df: pd.DataFrame, pop_wgt: Dict[str, float],
                    af1_cutoff: float = 0.01) -> "PreparedRun":
        """Join input against the in-memory index + AF filter, once for
        the whole region."""
        flags, wgts = readers.init_pop_flag_wgts(self.store.desc, pop_wgt)
        sel, cols, sizes = self._select(flags)
        table = variants.join_reference_index(
            input_df, self.store.index, add_unmeasured=True)
        # map fpos back to store rows
        fmap = pd.Series(np.arange(len(self.store.index)),
                         index=self.store.index["fpos"].to_numpy())
        g_row = np.full(len(table), -1, dtype=np.int64)
        has = table["fpos"].to_numpy() >= 0
        g_row[has] = fmap.reindex(table["fpos"].to_numpy()[has]).to_numpy()

        af1 = np.full(len(table), np.nan)
        af1[has] = self.store.af[g_row[has]][:, sel] @ wgts
        table = table.assign(af1mix=af1)
        # type-2 rows (~has) drop like the reference's MakeSnpVecMix
        # NaN-filter drops them (models/pipeline.load_window docstring)
        keep = has.copy()
        keep[has] = (af1[has] > af1_cutoff) & (af1[has] < 1 - af1_cutoff)
        table = table[keep].reset_index(drop=True)
        g_row = g_row[keep]
        return PreparedRun(self, table, g_row, cols, sizes,
                           tuple(float(x) for x in wgts))

    def prepare_homog(self, input_df: pd.DataFrame, study_pop: str,
                      af1_cutoff: float = 0.01) -> "PreparedRun":
        flags = readers.init_pop_flags(self.store.desc, study_pop)
        sel, cols, sizes = self._select(flags)
        table = variants.join_reference_index(
            input_df, self.store.index, add_unmeasured=True)
        fmap = pd.Series(np.arange(len(self.store.index)),
                         index=self.store.index["fpos"].to_numpy())
        g_row = np.full(len(table), -1, dtype=np.int64)
        has = table["fpos"].to_numpy() >= 0
        g_row[has] = fmap.reindex(table["fpos"].to_numpy()[has]).to_numpy()

        af1 = np.full(len(table), np.nan)
        counts = self.store.G[np.ix_(g_row[has], cols)].astype(np.int64).sum(axis=1)
        af = counts / (2.0 * float(sum(sizes)))
        af1[has] = np.ceil(af * 1e5) / 1e5
        table = table.assign(af1ref=af1)
        # type-2 rows drop like the reference's MakeSnpVec NaN-filter
        keep = has.copy()
        keep[has] = (af1[has] > af1_cutoff) & (af1[has] < 1 - af1_cutoff)
        table = table[keep].reset_index(drop=True)
        g_row = g_row[keep]
        return PreparedRun(self, table, g_row, cols, sizes, None)

    def prepare_genes(self, input_df: pd.DataFrame, annot_df: pd.DataFrame,
                      study_pop: Optional[str] = None,
                      pop_wgt: Optional[Dict[str, float]] = None,
                      af1_cutoff: float = 0.01) -> "PreparedGenes":
        """Join input + annotation against the resident panel once, for
        genome-scale jepeg/jepegmix (reference per-call pipeline:
        src/jepegmix.cpp:65-91, re-run for EVERY invocation there --
        here the panel is decoded once and gene correlation blocks are
        gathered from HBM).  Exactly one of study_pop (jepeg) /
        pop_wgt (jepegmix) must be given."""
        if (study_pop is None) == (pop_wgt is None):
            raise ValueError("exactly one of study_pop / pop_wgt required")
        if pop_wgt is not None:
            flags, wgts = readers.init_pop_flag_wgts(self.store.desc, pop_wgt)
            wgts = tuple(float(x) for x in wgts)
        else:
            flags = readers.init_pop_flags(self.store.desc, study_pop)
            wgts = None
        sel, cols, sizes = self._select(flags)

        table = variants.join_reference_index(
            input_df, self.store.index, add_unmeasured=False,
            flip_af1study=True)
        table, categs = variants.join_annotation(table, annot_df)

        fmap = pd.Series(np.arange(len(self.store.index)),
                         index=self.store.index["fpos"].to_numpy())
        g_row = np.full(len(table), -1, dtype=np.int64)
        has = table["fpos"].to_numpy() >= 0
        g_row[has] = fmap.reindex(table["fpos"].to_numpy()[has]).to_numpy()

        # MakeSnpVec[Mix] AF filter (src/gauss.cpp:543-693)
        n = len(table)
        af = np.full(n, np.nan)
        if wgts is None:
            counts = self.store.G[np.ix_(g_row[has], cols)].astype(
                np.int64).sum(axis=1)
            af[has] = np.ceil(counts / (2.0 * float(sum(sizes))) * 1e5) / 1e5
            table = table.assign(af1ref=af)
        else:
            af[has] = self.store.af[g_row[has]][:, sel] @ np.asarray(wgts)
            table = table.assign(af1mix=af)
        keep = has.copy()   # type-2 rows drop (MakeSnpVec NaN-filter)
        keep[has] = (af[has] > af1_cutoff) & (af[has] < 1 - af1_cutoff)

        # gene SNPs: measured + annotated (src/jepeg.cpp:73-79)
        typ = table["type"].to_numpy()
        gid = table["geneid"].to_numpy()
        gene_rows = np.flatnonzero(keep & (typ == 1) & (gid != "."))

        cw = np.zeros((n, 6))
        cp = np.zeros((n, 6), dtype=bool)
        if len(categs):
            r = categs["row"].to_numpy(dtype=np.int64)
            c = categs["categ"].to_numpy(dtype=np.int64)
            cw[r, c] = categs["wgt"].to_numpy()
            cp[r, c] = True

        # stable sort by geneid + contiguous runs (src/jepeg.cpp:87)
        sub = table.iloc[gene_rows]
        order = np.argsort(sub["geneid"].to_numpy(), kind="stable")
        gene_rows = gene_rows[order]
        sub = table.iloc[gene_rows]
        gids = sub["geneid"].to_numpy()
        starts = np.flatnonzero(
            np.concatenate([[True], gids[1:] != gids[:-1]])
        ) if len(gids) else np.zeros(0, dtype=np.int64)
        ends = (np.concatenate([starts[1:], [len(gids)]])
                if len(gids) else np.zeros(0, dtype=np.int64))
        bps = sub["bp"].to_numpy()
        gene_min_bp = np.asarray([bps[s:e].min() for s, e in
                                  zip(starts, ends)], dtype=np.int64)
        return PreparedGenes(
            engine=self, zs=sub["z"].to_numpy(),
            infos=sub["info"].to_numpy(), rsids=sub["rsid"].to_numpy(),
            gids=gids, panel_rows=g_row[gene_rows],
            spans=list(zip(starts.tolist(), ends.tolist())),
            gene_min_bp=gene_min_bp,
            cw_rows=cw[gene_rows], cp_rows=cp[gene_rows],
            subj_cols=cols, pop_sizes=sizes, wgts=wgts)

    # -- ancestry over the resident panel -----------------------------------
    def afmix(self, input_af_df: pd.DataFrame,
              interval: Optional[int] = None) -> pd.DataFrame:
        """Engine-resident afmix (no bgzf re-decode; reference
        src/afmix.cpp re-reads the panel per call)."""
        from . import ancestry
        return ancestry.afmix_store(self.store, input_af_df, interval,
                                    self.settings)

    def cpw2(self, input_af_df: pd.DataFrame,
             interval: Optional[int] = None) -> pd.DataFrame:
        from . import ancestry
        return ancestry.cpw2_store(self.store, input_af_df, interval,
                                   self.settings)

    def prep_zmix5(self, input_z_df: pd.DataFrame,
                   percentile: Optional[float] = None,
                   interval: Optional[int] = None,
                   sup_level: bool = False) -> np.ndarray:
        from . import ancestry
        return ancestry.prep_zmix5_store(self.store, input_z_df,
                                         percentile, interval, sup_level)

    def zmix(self, input_z_df: pd.DataFrame, percentile: float = 0.9,
             interval: int = 10, level: str = "population") -> pd.DataFrame:
        from . import ancestry
        return ancestry.zmix_store(self.store, input_z_df, percentile,
                                   interval, level)

    # -- compiled kernels --------------------------------------------------
    def _corr_fn(self, Mp: int, Up: int, sizes, wgts):
        key = (Mp, Up, sizes, wgts)
        fn = self._corr_fns.get(key)
        if fn is None:
            fn = _build_corr_blocks_fn(sizes, wgts)
            self._corr_fns[key] = fn
        return fn

    def _padded_sizes(self, sizes) -> Tuple[int, ...]:
        """Per-pop device-panel segment widths (K_TILE-aligned when the
        Pallas stats path is on; the zero padding is exact)."""
        if self.stats == "pallas":
            from ..ops.pallas_gram import K_TILE
            return tuple(_round_up(int(s), K_TILE) for s in sizes)
        return tuple(int(s) for s in sizes)

    def _spec(self, sizes, wgts) -> WindowKernelSpec:
        return WindowKernelSpec(
            pop_sizes=sizes, pop_sizes_padded=self._padded_sizes(sizes),
            wgts=wgts, lam=self.settings.lambda_,
            min_abs_eig=self.settings.min_abs_eig,
            eig_cutoff=self.settings.eig_cutoff, stats=self.stats)

    def _fused_fn(self, Mp: int, Up: int, sizes, wgts):
        key = (Mp, Up, sizes, wgts)
        fn = self._fused_fns.get(key)
        if fn is None:
            fn = build_gather_window_kernel(self._spec(sizes, wgts))
            self._fused_fns[key] = fn
        return fn

    def _region_fn(self, sizes, wgts):
        key = ("region", sizes, wgts)
        fn = self._fused_fns.get(key)
        if fn is None:
            fn = build_region_kernel(self._spec(sizes, wgts))
            self._fused_fns[key] = fn
        return fn

    def _sharded_fn(self, kind: str, sizes, wgts, local_sizes,
                    fetch: str = "f32"):
        """Mesh-sharded kernel (subject-sharded panel + window-parallel
        scan).  ``kind``: "region" | "qcat" | "ld".  ``local_sizes`` are
        the per-shard population segment widths from
        subject_shard_layout."""
        key = ("sharded", kind, sizes, wgts, local_sizes, fetch)
        fn = self._fused_fns.get(key)
        if fn is None:
            from ..parallel import mesh as pm
            spec = WindowKernelSpec(
                pop_sizes=sizes, pop_sizes_padded=local_sizes, wgts=wgts,
                lam=self.settings.lambda_,
                min_abs_eig=self.settings.min_abs_eig,
                eig_cutoff=self.settings.eig_cutoff,
                # sharded kernels psum raw additive sufficient stats;
                # "int8" selects the exact shifted-Gram protocol
                # (_int8_sharded_weighted_stats), falling back to the
                # centered f32 path for >23k-subject populations
                stats="int8")
            if kind == "ld":
                fn = pm.build_sharded_ld_kernel(spec, self.mesh,
                                                fetch=fetch)
            else:
                build = {"region": pm.build_sharded_region_kernel,
                         "qcat": pm.build_sharded_qcat_region_kernel}[kind]
                fn = build(spec, self.mesh)
            self._fused_fns[key] = fn
        return fn

    def _ld_fn(self, Mp: int, sizes, wgts, fetch: str = "f32"):
        key = ("ld", Mp, sizes, wgts, fetch)
        fn = self._fused_fns.get(key)
        if fn is None:
            fn = build_gather_ld_kernel(self._spec(sizes, wgts),
                                        fetch=fetch)
            self._fused_fns[key] = fn
        return fn

    def _resident_fn(self, Mp: int, Up: int, sizes, wgts):
        key = ("resident", Mp, Up, sizes, wgts)
        fn = self._fused_fns.get(key)
        if fn is None:
            fn = build_resident_region_kernel(self._spec(sizes, wgts),
                                              Mp, Up)
            self._fused_fns[key] = fn
        return fn


@dataclasses.dataclass
class PreparedRun:
    engine: GenomeEngine
    table: pd.DataFrame
    g_row: np.ndarray
    subj_cols: np.ndarray
    pop_sizes: Tuple[int, ...]
    wgts: Optional[Tuple[float, ...]]
    _G_dev: Optional[jnp.ndarray] = None
    _local_sizes: Optional[Tuple[int, ...]] = None
    _res: Dict = dataclasses.field(default_factory=dict)

    def _device_panel(self) -> jnp.ndarray:
        """Selected-population dosage matrix, uploaded to HBM once and
        reused by every window (the SURVEY section 7 design point).
        Population segments are zero-padded to the Pallas K-tile when
        the fused stats kernel is enabled (padding is exact: zero
        columns contribute 0 to every statistic).  With an engine mesh,
        the subject axis is instead laid out in subject_shard_layout
        order and placed sharded over the mesh's ``subject`` axis."""
        if self._G_dev is None:
            G = self.engine.store.G
            cols = self.subj_cols
            full = len(cols) == G.shape[1] and bool(
                np.array_equal(cols, np.arange(G.shape[1])))
            Gh = G if full else G[:, cols]
            mesh = self.engine.mesh
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P
                from ..parallel.mesh import subject_shard_layout
                n_sub = mesh.shape["subject"]
                G_l, _, locs = subject_shard_layout(Gh, self.pop_sizes,
                                                    n_sub)
                self._local_sizes = locs
                self._G_dev = jax.device_put(
                    G_l, NamedSharding(mesh, P(None, "subject")))
                return self._G_dev
            padded = self.engine._padded_sizes(self.pop_sizes)
            if padded != tuple(self.pop_sizes):
                from ..ops.pallas_gram import K_TILE
                Gh, got = pad_pop_segments(Gh, self.pop_sizes,
                                           multiple=K_TILE)
                assert got == padded
            self._G_dev = jnp.asarray(Gh)
        return self._G_dev

    def _mesh_fn(self, kind: str, fetch: str = "f32"):
        """Sharded kernel for this run's panel layout (the panel upload
        fixes _local_sizes first)."""
        panel = self._device_panel()
        fn = self.engine._sharded_fn(kind, self.pop_sizes, self.wgts,
                                     self._local_sizes, fetch=fetch)
        return panel, fn

    def _dispatch_device(self, m_rows, u_rows, M, U, Mp, Up, Z1,
                         m_mask, u_mask):
        """Launch the fused kernel asynchronously; returns lazy device
        arrays (z, info).  Only index vectors + Z cross the host link."""
        mesh = self.engine.mesh
        n_win = 1 if mesh is None else mesh.shape["window"]
        m_idx = np.zeros((n_win, Mp), dtype=np.int32)
        u_idx = np.zeros((n_win, Up), dtype=np.int32)
        m_idx[0, :M] = self.g_row[m_rows]
        u_idx[0, :U] = self.g_row[u_rows]
        if mesh is not None:
            # single window over the mesh: rows 1..n_win-1 are masked
            # padding windows (legal; outputs dropped)
            panel, fn = self._mesh_fn("region")
            pad = lambda a: np.concatenate(
                [a, np.zeros((n_win - 1,) + a.shape[1:], a.dtype)])
            z, info = fn(panel, m_idx, u_idx, pad(Z1), pad(m_mask),
                         pad(u_mask))
            return z[:1], info[:1]
        fn = self.engine._fused_fn(Mp, Up, self.pop_sizes, self.wgts)
        return fn(self._device_panel(), m_idx, u_idx, Z1, m_mask, u_mask)

    def _window_plan(self, start_bp: int, end_bp: int, wing_size: int):
        """Row selection for one window, or None if below the reference
        minimum SNP counts (src/dist.cpp:145-151)."""
        st = self.engine.settings
        t = self.table
        bp = t["bp"].to_numpy()
        typ = t["type"].to_numpy()
        in_ext = (bp >= start_bp - wing_size) & (bp <= end_bp + wing_size)
        m_rows = np.flatnonzero(in_ext & (typ == 1))
        u_rows = np.flatnonzero((typ == 0) & (bp >= start_bp) & (bp <= end_bp))
        M, U = len(m_rows), len(u_rows)
        if M <= st.min_num_measured_snp or U <= st.min_num_unmeasured_snp:
            return None
        bucket = self.engine.snp_bucket
        Mp, Up = _round_up(M, bucket), _round_up(U, bucket)
        Z1 = np.zeros((1, Mp))
        Z1[0, :M] = t["z"].to_numpy()[m_rows]
        m_mask = np.zeros((1, Mp), dtype=np.float32)
        u_mask = np.zeros((1, Up), dtype=np.float32)
        m_mask[0, :M] = 1
        u_mask[0, :U] = 1
        return m_rows, u_rows, M, U, Mp, Up, Z1, m_mask, u_mask

    def impute_window(self, start_bp: int, end_bp: int,
                      wing_size: int) -> Optional[WindowResult]:
        """Impute one prediction window (reference semantics of
        run_distmix, src/distmix.cpp:138-253)."""
        eng = self.engine
        st = eng.settings
        t = self.table
        plan = self._window_plan(start_bp, end_bp, wing_size)
        if plan is None:
            return None
        m_rows, u_rows, M, U, Mp, Up, Z1, m_mask, u_mask = plan

        if eng.device_linalg:
            z, info = self._dispatch_device(m_rows, u_rows, M, U, Mp, Up,
                                            Z1, m_mask, u_mask)
            z = np.asarray(z)[0, :U].astype(np.float64)
            info = np.asarray(info)[0, :U].astype(np.float64)
        else:
            S = len(self.subj_cols)
            Gm = np.zeros((1, Mp, S), dtype=np.int8)
            Gu = np.zeros((1, Up, S), dtype=np.int8)
            Gm[0, :M] = self.engine.store.G[np.ix_(self.g_row[m_rows],
                                                   self.subj_cols)]
            Gu[0, :U] = self.engine.store.G[np.ix_(self.g_row[u_rows],
                                                   self.subj_cols)]
            fn = eng._corr_fn(Mp, Up, self.pop_sizes, self.wgts)
            B11, B21 = fn(jnp.asarray(Gm[0]), jnp.asarray(Gu[0]))
            B11 = np.array(B11[:M, :M])
            B21 = np.array(B21[:U, :M])
            np.fill_diagonal(B11, 1.0 + st.lambda_)
            B11 = linalg.make_pos_def(B11, st.min_abs_eig)
            A = B21 @ linalg.inv_mat(B11)
            z2 = A @ Z1[0, :M]
            info = np.abs(np.einsum("um,um->u", A, B21))
            z = z2 / np.sqrt(info)

        return self._assemble(start_bp, end_bp, u_rows, z, info, M, U)

    def _assemble(self, start_bp, end_bp, u_rows, z, info, M, U
                  ) -> WindowResult:
        """Output rows for the prediction window (pval = 2*Phi(-|z|),
        src/distmix.cpp:100-134)."""
        t = self.table
        bp = t["bp"].to_numpy()
        out_z = t["z"].to_numpy().copy()
        out_info = t["info"].to_numpy().copy()
        out_z[u_rows] = z
        out_info[u_rows] = info
        mask = (bp >= start_bp) & (bp <= end_bp)
        tt = t[mask]
        sel = np.flatnonzero(mask)
        af_col = "af1mix" if self.wgts is not None else "af1ref"
        res = pd.DataFrame({
            "rsid": tt["rsid"].to_numpy(),
            "chr": tt["chr"].to_numpy(),
            "bp": tt["bp"].to_numpy(),
            "a1": tt["a1"].to_numpy(),
            "a2": tt["a2"].to_numpy(),
            af_col: tt[af_col].to_numpy(),
            "z": out_z[sel],
            "pval": pnorm_two_sided(out_z[sel]),
            "info": out_info[sel],
            "type": tt["type"].to_numpy(),
        })
        return WindowResult(table=res, n_measured=M, n_unmeasured=U)

    def ld_window(self, start_bp: int, end_bp: int,
                  fetch: str = "f32") -> Optional[Dict]:
        """Ancestry-weighted LD matrix of the window's MEASURED SNPs
        over the resident panel (computeLD semantics: wing = 0, diag
        1.0, no ridge; src/computeLD.cpp:26-166).  Returns
        {'snplist': DataFrame, 'cormat': float64 [n, n]} or None when
        the window has no measured SNPs.

        ``fetch``: "f32" (default) transfers the full matrix at the
        kernel's full precision; "i16tri" the packed int16 lower
        triangle -- 1/8 the bytes, |dr| <= LD_I16_MAX_ERR ~ 1.5e-5
        (opt-in throughput mode; the returned dict records the mode
        under "fetch" so consumers can detect quantization)."""
        if self.wgts is None:
            raise ValueError("ld_window requires population weights "
                             "(prepare_mix)")
        t = self.table
        bp = t["bp"].to_numpy()
        typ = t["type"].to_numpy()
        m_rows = np.flatnonzero((typ == 1) & (bp >= start_bp)
                                & (bp <= end_bp))
        M = len(m_rows)
        if M == 0:
            return None
        mesh = self.engine.mesh
        n_win = 1 if mesh is None else mesh.shape["window"]
        Mp = _round_up(M, self.engine.snp_bucket)
        m_idx = np.zeros((n_win, Mp), dtype=np.int32)
        m_idx[0, :M] = self.g_row[m_rows]
        m_mask = np.zeros((n_win, Mp), dtype=np.float32)
        m_mask[0, :M] = 1.0
        if mesh is not None:
            panel, fn = self._mesh_fn("ld", fetch=fetch)
        else:
            panel = self._device_panel()
            fn = self.engine._ld_fn(Mp, self.pop_sizes, self.wgts,
                                    fetch=fetch)
        out = np.asarray(fn(panel, m_idx, m_mask))
        cormat = (unpack_tri_i16(out[0], Mp, M) if fetch == "i16tri"
                  else out[0, :M, :M].astype(np.float64))
        tt = t.iloc[m_rows]
        snplist = pd.DataFrame({
            "rsid": tt["rsid"].to_numpy(), "chr": tt["chr"].to_numpy(),
            "bp": tt["bp"].to_numpy(), "a1": tt["a1"].to_numpy(),
            "a2": tt["a2"].to_numpy(),
            "af1mix": tt["af1mix"].to_numpy(),
            "z": tt["z"].to_numpy(),
        })
        return {"snplist": snplist, "cormat": cormat, "fetch": fetch}

    def _ld_windows(self, start_bp: int, end_bp: int, window_bp: int):
        """Measured-SNP row lists of consecutive LD windows (computeLD
        tiling: wing = 0, empty windows skipped) -- the single source
        of window semantics for ld_region and its mesh variant."""
        t = self.table
        bp = t["bp"].to_numpy()
        typ = t["type"].to_numpy()
        windows = []
        pos = start_bp
        while pos <= end_bp:
            hi = min(pos + window_bp - 1, end_bp)
            m_rows = np.flatnonzero((typ == 1) & (bp >= pos) & (bp <= hi))
            if len(m_rows):
                windows.append(m_rows)
            pos = hi + 1
        return windows

    def ld_region(self, start_bp: int, end_bp: int,
                  window_bp: int = 1_000_000,
                  fetch: str = "i16tri") -> List[Dict]:
        """ld_window over consecutive windows.  On the GPU the windows
        run as ONE batched-window resident dispatch (see below); on CPU /
        gather mode every window is dispatched before any matrix is
        fetched so fetches overlap dispatches.

        ``fetch`` defaults to "i16tri" (engine throughput mode,
        VERDICT r4 item 3): packed int16 triangles, 1/8 the bytes of
        f32 with |dr| <= LD_I16_MAX_ERR ~ 1.5e-5 -- below the f32
        statistics noise at 33k subjects; the mode is recorded under
        "fetch" in each dict.  Pass fetch="f32" for full-precision
        fetches; the per-call compute_ld API stays float64 exact."""
        if self.wgts is None:
            # computeLD is the ancestry-WEIGHTED estimator only
            # (src/computeLD.cpp:26-166 takes pop_wgt_df; there is no
            # pooled variant in the reference) -- same contract as
            # ld_window
            raise ValueError("ld_region requires population weights "
                             "(prepare_mix)")
        t = self.table
        mesh = self.engine.mesh
        if mesh is not None:
            return self._ld_region_mesh(start_bp, end_bp, window_bp,
                                        fetch=fetch)
        windows = self._ld_windows(start_bp, end_bp, window_bp)
        if not windows:
            return []
        if (self.engine._use_resident(self.wgts)
                and os.environ.get("GAUSS_LD_RESIDENT") != "0"):
            # one-dispatch resident LD: every window's Gram in one
            # batched-window kernel call, no per-window round trips;
            # _ld_resident_region pulls per-window rows on a small
            # thread pool so several host transfers run at once.
            raw_all, Mp, locs, fmt = self._ld_resident_region(windows,
                                                              fetch)
        else:
            fmt = "tri" if fetch == "i16tri" else "f32"
            # ONE bucketed shape for the whole region: a couple of
            # windows pay extra padding, but the region compiles a
            # single LD kernel instead of one per Mp bucket
            # (cold-compile cost dominates any fresh-cache run
            # otherwise).  Per-window dispatch + per-window fetch
            # deliberately: the fetches overlap the later windows'
            # dispatches.
            Mp = _round_up(max(len(r) for r in windows),
                           self.engine.snp_bucket)
            fn = self.engine._ld_fn(Mp, self.pop_sizes, self.wgts,
                                    fetch=fetch)
            pending = [fn(self._device_panel(), *self._ld_window_inputs(
                m_rows, Mp)) for m_rows in windows]
            raw_all = [np.asarray(p)[0] for p in pending]
            locs = [0] * len(windows)
        out = []
        for m_rows, raw_row, loc in zip(windows, raw_all, locs):
            M = len(m_rows)
            if fmt == "tri":            # exact triangle (loc: resident
                full = unpack_tri_i16(raw_row, Mp, loc + M)  # rebase)
                cormat = full[loc:loc + M, loc:loc + M]
            elif fmt == "blocktri":     # resident, block triangle
                from ..ops.window_kernel import unpack_block_tri_i16
                full = unpack_block_tri_i16(raw_row, Mp, loc + M)
                cormat = full[loc:loc + M, loc:loc + M]
            elif raw_row.dtype == np.int16:  # resident, quantized full
                from ..ops.window_kernel import _dequant_i16
                cormat = _dequant_i16(raw_row[loc:loc + M, loc:loc + M])
            else:
                cormat = raw_row[loc:loc + M, loc:loc + M].astype(
                    np.float64)
            tt = t.iloc[m_rows]
            out.append({
                "snplist": pd.DataFrame({
                    "rsid": tt["rsid"].to_numpy(),
                    "chr": tt["chr"].to_numpy(),
                    "bp": tt["bp"].to_numpy(),
                    "a1": tt["a1"].to_numpy(),
                    "a2": tt["a2"].to_numpy(),
                    "af1mix": tt["af1mix"].to_numpy(),
                    "z": tt["z"].to_numpy()}),
                "cormat": cormat,
                "fetch": fetch,
            })
        return out

    def _ld_window_inputs(self, m_rows, Mp):
        M = len(m_rows)
        m_idx = np.zeros((1, Mp), dtype=np.int32)
        m_idx[0, :M] = self.g_row[m_rows]
        m_mask = np.zeros((1, Mp), dtype=np.float32)
        m_mask[0, :M] = 1.0
        return m_idx, m_mask

    def _ld_resident_region(self, windows, fetch):
        """One-dispatch resident computeLD: every window is a
        contiguous band of the bp-sorted measured panel, streamed by
        build_resident_ld_kernel; returns (raw [W, ...], Mp, per-window
        band row offsets)."""
        fn, args, W, SL, entries, m_loc = self._ld_resident_parts(
            windows, fetch)
        out = fn(*args)
        # per-window rows fetched on a thread pool: several host
        # transfers in flight at once
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(4) as ex:
            raw = list(ex.map(lambda i: np.asarray(out[i]), range(W)))
        # device-side slicing re-bases each window to its in-slice
        # offset loc - m_loc (0 unless clamped)
        locs = [e[0] - int(m_loc[i]) for i, e in enumerate(entries)]
        fmt = "blocktri" if fetch == "i16tri" else fetch
        return raw, SL, locs, fmt

    def _ld_resident_parts(self, windows, fetch):
        from ..ops.pallas_gram import ROW_TILE as R
        from ..ops.window_kernel import build_resident_ld_kernel
        t = self.table
        typ = t["type"].to_numpy()
        m_all = np.flatnonzero(typ == 1)
        entries = []
        for m_rows in windows:
            M = len(m_rows)
            mpos = int(np.searchsorted(m_all, m_rows[0]))
            assert m_all[mpos + M - 1] == m_rows[-1], "non-contiguous"
            mt0 = mpos // R                   # ROW_TILE units
            entries.append((mpos - mt0 * R, mt0))
        Mp = _round_up(max(loc + len(r)
                           for (loc, _), r in zip(entries, windows)), R)
        # useful-block bucket: only [SL, SL] blocks leave the device
        SL = _round_up(max(len(r) for r in windows), 128)
        W = len(windows)
        from ..ops.window_kernel import _win_slabs
        Wp = W if _win_slabs(W) == W else _round_up(
            W, self.engine.window_bucket)
        m_t0 = np.zeros(Wp, dtype=np.int32)
        m_loc = np.zeros(Wp, dtype=np.int32)
        m_maskb = np.zeros((Wp, Mp), dtype=np.float32)
        for i, ((loc, mt0), m_rows) in enumerate(zip(entries, windows)):
            m_t0[i] = mt0
            # slice offset clamped so [loc, loc+SL) stays inside the band
            m_loc[i] = min(loc, Mp - SL)
            m_maskb[i, loc:loc + len(m_rows)] = 1.0
        Xm, Xu, Spm, Spu, Mum, Muu, Vu = self._resident_arrays(Mp, R)
        key = ("resident_ld", Mp, SL, fetch, self.pop_sizes, self.wgts)
        fn = self.engine._fused_fns.get(key)
        if fn is None:
            fn = build_resident_ld_kernel(
                self.engine._spec(self.pop_sizes, self.wgts), Mp,
                fetch=fetch, SL=SL)
            self.engine._fused_fns[key] = fn
        args = (Xm, Spm, Mum, jnp.asarray(m_t0), jnp.asarray(m_loc),
                jnp.asarray(m_maskb))
        return fn, args, W, SL, entries, m_loc

    def _ld_region_mesh(self, start_bp: int, end_bp: int,
                        window_bp: int, fetch: str = "f32") -> List[Dict]:
        """Mesh variant of ld_region: all windows padded to one Mp and
        computed in a single dispatch split over the window axis."""
        t = self.table
        windows = self._ld_windows(start_bp, end_bp, window_bp)
        if not windows:
            return []
        n_win = self.engine.mesh.shape["window"]
        Mp = _round_up(max(len(r) for r in windows), self.engine.snp_bucket)
        Wp = _round_up(len(windows), n_win)
        m_idx = np.zeros((Wp, Mp), dtype=np.int32)
        m_mask = np.zeros((Wp, Mp), dtype=np.float32)
        for i, m_rows in enumerate(windows):
            m_idx[i, :len(m_rows)] = self.g_row[m_rows]
            m_mask[i, :len(m_rows)] = 1.0
        panel, fn = self._mesh_fn("ld", fetch=fetch)
        corr = np.asarray(fn(panel, m_idx, m_mask))
        out = []
        for i, m_rows in enumerate(windows):
            M = len(m_rows)
            tt = t.iloc[m_rows]
            out.append({
                "snplist": pd.DataFrame({
                    "rsid": tt["rsid"].to_numpy(),
                    "chr": tt["chr"].to_numpy(),
                    "bp": tt["bp"].to_numpy(),
                    "a1": tt["a1"].to_numpy(),
                    "a2": tt["a2"].to_numpy(),
                    "af1mix": tt["af1mix"].to_numpy(),
                    "z": tt["z"].to_numpy()}),
                "cormat": (unpack_tri_i16(corr[i], Mp, M)
                           if fetch == "i16tri"
                           else corr[i, :M, :M].astype(np.float64)),
                "fetch": fetch,
            })
        return out

    def qcat_region(self, start_bp: int, end_bp: int,
                    window_bp: int = 1_000_000,
                    wing_size: int = 500_000) -> pd.DataFrame:
        """QCAT causality tests over consecutive windows as ONE device
        dispatch (qcatmix semantics when prepared with weights, qcat
        otherwise; reference src/qcat.cpp:134-262).  NOTE the reference
        defaults differ: qcat's af1_cutoff is 0.05
        (src/qcat.cpp:52-56) but qcatmix's is 0.01
        (src/qcatmix.cpp:61-64) -- pass the matching value to
        prepare_homog / prepare_mix."""
        spans = []
        lo = start_bp
        while lo <= end_bp:
            hi = min(lo + window_bp - 1, end_bp)
            spans.append((lo, hi))
            lo = hi + 1
        plans = []
        for lo, hi in spans:
            plan = self._window_plan(lo, hi, wing_size)
            if plan is not None:
                plans.append((lo, hi, plan))
        if not plans:
            return pd.DataFrame()
        t = self.table
        bp = t["bp"].to_numpy()
        zcol = t["z"].to_numpy()
        Mp = max(p[2][4] for p in plans)
        Up = max(p[2][5] for p in plans)
        W = len(plans)
        mesh = self.engine.mesh
        n_win = 1 if mesh is None else mesh.shape["window"]
        Wp = _round_up(W, self.engine.window_bucket * n_win)
        m_idx = np.zeros((Wp, Mp), dtype=np.int32)
        u_idx = np.zeros((Wp, Up), dtype=np.int32)
        Z1b = np.zeros((Wp, Mp))
        m_maskb = np.zeros((Wp, Mp), dtype=np.float32)
        u_maskb = np.zeros((Wp, Up), dtype=np.float32)
        for i, (_, _, plan) in enumerate(plans):
            m_rows, u_rows, M, U, *_ = plan
            m_idx[i, :M] = self.g_row[m_rows]
            u_idx[i, :U] = self.g_row[u_rows]
            Z1b[i, :M] = zcol[m_rows]
            m_maskb[i, :M] = 1.0
            u_maskb[i, :U] = 1.0
        if mesh is not None:
            panel, fn = self._mesh_fn("qcat")
            outs = fn(panel, m_idx, u_idx, Z1b, m_maskb, u_maskb)
            plans_loc = [(lo, hi, plan, (0, 0)) for lo, hi, plan in plans]
        elif self.engine._use_resident(self.wgts):
            # gather-free resident streaming (same contiguity argument
            # as impute_region; see build_resident_qcat_kernel)
            plans_loc, inputs, Mp_r, Up_r = self._resident_batch_from_plans(
                plans, zcol)
            arrays = self._resident_arrays(Mp_r, Up_r)
            key = ("resident_qcat", Mp_r, Up_r, self.pop_sizes, self.wgts)
            fn = self.engine._fused_fns.get(key)
            if fn is None:
                from ..ops.window_kernel import build_resident_qcat_kernel
                fn = build_resident_qcat_kernel(
                    self.engine._spec(self.pop_sizes, self.wgts),
                    Mp_r, Up_r)
                self.engine._fused_fns[key] = fn
            outs = fn(*arrays, *inputs)
        else:
            panel = self._device_panel()
            key = ("qcat_region", self.pop_sizes, self.wgts)
            fn = self.engine._fused_fns.get(key)
            if fn is None:
                fn = build_qcat_region_kernel(
                    self.engine._spec(self.pop_sizes, self.wgts))
                self.engine._fused_fns[key] = fn
            outs = fn(panel, m_idx, u_idx, Z1b, m_maskb, u_maskb)
            plans_loc = [(lo, hi, plan, (0, 0)) for lo, hi, plan in plans]
        t_m, chi_m, t_u, chi_u, n_eig = (np.asarray(a) for a in outs)

        qm = np.zeros(len(t), dtype=np.int64)
        qt = np.zeros(len(t))
        qc = np.zeros(len(t))
        emit = np.zeros(len(t), dtype=bool)
        for i, (lo, hi, plan, (mloc, uloc)) in enumerate(plans_loc):
            m_rows, u_rows, M, U, *_ = plan
            pm = (bp[m_rows] >= lo) & (bp[m_rows] <= hi)
            rows = m_rows[pm]
            qm[rows] = int(n_eig[i])
            qt[rows] = t_m[i, mloc:mloc + M][pm].astype(np.float64)
            qc[rows] = chi_m[i, mloc:mloc + M][pm].astype(np.float64)
            qm[u_rows] = int(n_eig[i])
            qt[u_rows] = t_u[i, uloc:uloc + U].astype(np.float64)
            qc[u_rows] = chi_u[i, uloc:uloc + U].astype(np.float64)
            emit |= (bp >= lo) & (bp <= hi)
        tt = t[emit]
        sel = np.flatnonzero(emit)
        af_col = "af1mix" if self.wgts is not None else "af1ref"
        return pd.DataFrame({
            "rsid": tt["rsid"].to_numpy(),
            "chr": tt["chr"].to_numpy(),
            "bp": tt["bp"].to_numpy(),
            "a1": tt["a1"].to_numpy(),
            "a2": tt["a2"].to_numpy(),
            af_col: tt[af_col].to_numpy(),
            "z": tt["z"].to_numpy(),
            "qcat_m": qm[sel],
            "qcat_t": qt[sel],
            "qcat_chisq": qc[sel],
            "qcat_pval": pchisq_upper(qc[sel], 1),
            "type": tt["type"].to_numpy(),
        })

    def _resident_arrays(self, Mp: int, Up: int):
        """Resident bp-sorted measured/unmeasured panels + per-row
        statistics for the gather-free region kernel
        (ops/window_kernel.build_resident_region_kernel).  Cached;
        rebuilt only if a larger slice cap than cached is requested."""
        from ..ops.pallas_gram import ROW_TILE as R
        cached = self._res.get("caps")
        if cached is not None and cached[0] >= Mp and cached[1] >= Up:
            return self._res["arrays"]
        if cached is not None:       # grow monotonically: alternating
            Mp = max(Mp, cached[0])  # callers must not thrash rebuilds
            Up = max(Up, cached[1])
        t = self.table
        typ = t["type"].to_numpy()
        m_all = np.flatnonzero(typ == 1)
        u_all = np.flatnonzero(typ == 0)
        spec = self.engine._spec(self.pop_sizes, self.wgts)
        G_dev = self._device_panel()

        def build(rows_tbl, cap):
            n = len(rows_tbl)
            RN = _round_up(max(n, 1), R) + cap
            rows = np.zeros(RN, dtype=np.int32)
            rows[:n] = self.g_row[rows_tbl]
            return prepare_resident_panel(G_dev, jnp.asarray(rows), n,
                                          spec)
        Xm, Spm, Mum, _ = build(m_all, Mp)
        Xu, Spu, Muu, Vu = build(u_all, Up)
        # update in place: self._res also caches ("batch", ...) /
        # ("asm", ...) entries that must survive a cap-growing rebuild
        # (already-built batches captured the OLD arrays, which stay
        # valid for their own caps)
        self._res.update({"arrays": (Xm, Xu, Spm, Spu, Mum, Muu, Vu),
                          "caps": (Mp, Up)})
        return self._res["arrays"]

    def _resident_batch_from_plans(self, plans, zcol):
        """Per-window band offsets + padded Z1/mask batch for the
        resident kernels.  Windows select bp ranges of the bp-sorted
        table, so their rows are contiguous runs of the measured /
        unmeasured row lists (asserted).  Band offsets (in ROW_TILE
        units) and Mp/Up align to ROW_TILE rows."""
        from ..ops.pallas_gram import ROW_TILE as R
        t = self.table
        typ = t["type"].to_numpy()
        m_all = np.flatnonzero(typ == 1)
        u_all = np.flatnonzero(typ == 0)
        entries = []
        for lo, hi, plan in plans:
            m_rows, u_rows, M, U, *_ = plan
            mpos = int(np.searchsorted(m_all, m_rows[0]))
            upos = int(np.searchsorted(u_all, u_rows[0]))
            assert m_all[mpos + M - 1] == m_rows[-1], "non-contiguous"
            assert u_all[upos + U - 1] == u_rows[-1], "non-contiguous"
            mt0, ut0 = mpos // R, upos // R    # ROW_TILE units
            entries.append((mpos - mt0 * R, upos - ut0 * R, mt0, ut0))
        Mp = _round_up(max(e[0] + p[2][2]
                           for e, p in zip(entries, plans)), R)
        Up = _round_up(max(e[1] + p[2][3]
                           for e, p in zip(entries, plans)), R)
        W = len(plans)
        from ..ops.window_kernel import _win_slabs
        Wp = W if _win_slabs(W) == W else _round_up(
            W, self.engine.window_bucket)
        m_t0 = np.zeros(Wp, dtype=np.int32)
        u_t0 = np.zeros(Wp, dtype=np.int32)
        Z1b = np.zeros((Wp, Mp))
        m_maskb = np.zeros((Wp, Mp), dtype=np.float32)
        u_maskb = np.zeros((Wp, Up), dtype=np.float32)
        plans_out = []
        for i, ((mloc, uloc, mt0, ut0), (lo, hi, plan)) in enumerate(
                zip(entries, plans)):
            m_rows, u_rows, M, U, *_ = plan
            m_t0[i] = mt0
            u_t0[i] = ut0
            Z1b[i, mloc:mloc + M] = zcol[m_rows]
            m_maskb[i, mloc:mloc + M] = 1.0
            u_maskb[i, uloc:uloc + U] = 1.0
            plans_out.append((lo, hi, plan, (mloc, uloc)))
        return plans_out, (m_t0, u_t0, Z1b, m_maskb, u_maskb), Mp, Up

    def _region_batch(self, start_bp: int, end_bp: int, window_bp: int,
                      wing_size: int):
        """Plans + padded batch inputs + compiled kernel for the
        one-dispatch region scan, or None when no window clears the
        minimum counts.  Shared by impute_region and
        impute_region_async.

        Returns (plans, inputs, panel_pack, fn) with fn(*panel_pack,
        *inputs) -> (z, info); each plans entry is (lo, hi, plan,
        (m_loc, u_loc)) where the locs give the window's row offset
        inside its padded batch slot (0 on the gather paths).

        The table is immutable after prepare, so the batch is cached
        per (start, end, window_bp, wing) -- repeated region calls
        (benchmark passes, resumed runs) skip the host-side plan and
        mask construction entirely."""
        ck = (start_bp, end_bp, window_bp, wing_size)
        hit = self._res.get(("batch", ck))
        if hit is not None:
            return hit
        out = self._region_batch_build(start_bp, end_bp, window_bp,
                                       wing_size)
        # the aligned layout gives each batch DEDICATED device panels
        # (up to several GB); keep only the newest such batch so a
        # genome-scale sweep over distinct spans does not accumulate
        # one panel per region in HBM (repeat calls on one span --
        # the bench / resumed runs -- still hit the cache above).
        # Aligned batches are the resident ones (7 inputs incl. wi/ci)
        # whose arrays tuple is NOT the shared self._res["arrays"];
        # the shared-fallback batch may also fail the identity test
        # after a cap-growing rebuild -- evicting it too costs only a
        # host-side plan rebuild, never device memory.
        def _aligned(b):
            return (b is not None and len(b[1]) == 7
                    and b[2] is not self._res.get("arrays"))
        if _aligned(out):
            for k in [k for k in self._res
                      if isinstance(k, tuple) and k[0] == "batch"
                      and k[1] != ck]:
                if _aligned(self._res[k]):
                    del self._res[k]
                    self._res.pop(("asm", k[1]), None)
        self._res[("batch", ck)] = out
        return out

    def _resident_aligned_batch(self, plans, zcol):
        """Per-window ALIGNED resident layout for the impute region
        kernel: each window's measured/unmeasured rows are re-gathered
        into their own ROW_TILE-aligned band of a dedicated panel (pad
        rows = -1 sentinels between bands), so every band offset is 0
        and the padded shapes shrink to round_up(max M/U, ROW_TILE) --
        vs the shared bp-sorted layout where the in-band offset
        loc < R inflates Mp/Up by up to one extra ROW_TILE, growing
        BOTH the Gram pair count and the O(Mp^2 Up) solves by ~20-35%.
        Measured-extended windows overlap (wings), so measured rows
        duplicate across bands (~2.4x one-time gather + HBM; unmeasured
        prediction windows are disjoint -- padding only).

        Returns (plans_out, inputs, arrays) with the same contracts as
        _resident_batch_from_plans/_resident_arrays; arrays are
        per-batch (cached by the _region_batch key), not shared."""
        from ..ops.pallas_gram import ROW_TILE
        from ..ops.window_kernel import prepare_resident_panel
        Mp = _round_up(max(p[2][2] for p in plans), ROW_TILE)
        Up = _round_up(max(p[2][3] for p in plans), ROW_TILE)
        W = len(plans)
        from ..ops.window_kernel import _win_slabs
        # the batched kernel needs no window padding when the region
        # fits one slab; only the slab-scan fallback needs W divisible
        Wp = W if _win_slabs(W) == W else _round_up(
            W, self.engine.window_bucket)
        rows_m = np.full(Wp * Mp, -1, dtype=np.int32)
        rows_u = np.full(Wp * Up, -1, dtype=np.int32)
        m_t0 = np.zeros(Wp, dtype=np.int32)
        u_t0 = np.zeros(Wp, dtype=np.int32)
        Z1b = np.zeros((Wp, Mp))
        m_maskb = np.zeros((Wp, Mp), dtype=np.float32)
        u_maskb = np.zeros((Wp, Up), dtype=np.float32)
        plans_out = []
        for i, (lo, hi, plan) in enumerate(plans):
            m_rows, u_rows, M, U, *_ = plan
            rows_m[i * Mp:i * Mp + M] = self.g_row[m_rows]
            rows_u[i * Up:i * Up + U] = self.g_row[u_rows]
            m_t0[i] = i * (Mp // ROW_TILE)
            u_t0[i] = i * (Up // ROW_TILE)
            Z1b[i, :M] = zcol[m_rows]
            m_maskb[i, :M] = 1.0
            u_maskb[i, :U] = 1.0
        for i in range(W, Wp):           # padding windows: empty bands
            m_t0[i] = i * (Mp // ROW_TILE)
            u_t0[i] = i * (Up // ROW_TILE)
        spec = self.engine._spec(self.pop_sizes, self.wgts)
        G_dev = self._device_panel()
        Xm, Spm, Mum, _ = prepare_resident_panel(
            G_dev, jnp.asarray(rows_m), None, spec)
        Xu, Spu, Muu, Vu = prepare_resident_panel(
            G_dev, jnp.asarray(rows_u), None, spec)
        arrays = (Xm, Xu, Spm, Spu, Mum, Muu, Vu)
        plans_out = [(lo, hi, plan, (0, 0)) for lo, hi, plan in plans]
        return plans_out, (m_t0, u_t0, Z1b, m_maskb, u_maskb), arrays, \
            Mp, Up

    def _region_batch_build(self, start_bp: int, end_bp: int,
                            window_bp: int, wing_size: int):
        spans = []
        lo = start_bp
        while lo <= end_bp:
            hi = min(lo + window_bp - 1, end_bp)
            spans.append((lo, hi))
            lo = hi + 1
        plans = []
        for lo, hi in spans:
            plan = self._window_plan(lo, hi, wing_size)
            if plan is not None:
                plans.append((lo, hi, plan))
        if not plans:
            return None
        zcol = self.table["z"].to_numpy()
        mesh = self.engine.mesh

        if self.engine._use_resident(self.wgts):
            # aligned layout duplicates measured bands across wings
            # (~2.4x rows); cap its HBM footprint -- very long direct
            # regions (callers should chunk via GenomeRunner) fall back
            # to the shared bp-sorted layout
            from ..ops.pallas_gram import ROW_TILE as R
            Mp_a = _round_up(max(p[2][2] for p in plans), R)
            Up_a = _round_up(max(p[2][3] for p in plans), R)
            # cap by BYTES (rows x padded subject axis), not rows: the
            # footprint scales with the panel's subject width too
            S_pad = int(sum(self.engine._padded_sizes(self.pop_sizes)))
            n_bytes = len(plans) * (Mp_a + Up_a) * S_pad
            max_bytes = int(os.environ.get("GAUSS_ALIGNED_MAX_BYTES",
                                           9_000_000_000))
            if n_bytes <= max_bytes:
                plans_out, inputs, arrays, Mp, Up = \
                    self._resident_aligned_batch(plans, zcol)
            else:
                plans_out, inputs, Mp, Up = \
                    self._resident_batch_from_plans(plans, zcol)
                arrays = self._resident_arrays(Mp, Up)
            fn = self.engine._resident_fn(Mp, Up, self.pop_sizes,
                                          self.wgts)
            # compaction indices (same order as _region_assembly's
            # win/col): the kernel gathers only REAL unmeasured rows
            # so the host fetch skips the ~30% Up padding
            wi = np.concatenate([
                np.full(p[2][3], i, dtype=np.int32)
                for i, p in enumerate(plans_out)])
            ci = np.concatenate([
                np.int32(p[3][1]) + np.arange(p[2][3], dtype=np.int32)
                for p in plans_out])
            inputs = inputs + (wi, ci)
            # upload the pass-invariant batch inputs once: repeated
            # region calls then dispatch with zero host->device traffic
            inputs = tuple(jnp.asarray(a) for a in inputs)
            return plans_out, inputs, arrays, fn

        Mp = max(p[2][4] for p in plans)
        Up = max(p[2][5] for p in plans)
        W = len(plans)
        n_win = 1 if mesh is None else mesh.shape["window"]
        # W must split evenly over the window axis AND each shard's
        # slice must divide by the scan batch width
        Wp = _round_up(W, self.engine.window_bucket * n_win)
        m_idx = np.zeros((Wp, Mp), dtype=np.int32)
        u_idx = np.zeros((Wp, Up), dtype=np.int32)
        Z1b = np.zeros((Wp, Mp))
        m_maskb = np.zeros((Wp, Mp), dtype=np.float32)
        u_maskb = np.zeros((Wp, Up), dtype=np.float32)
        for i, (_, _, plan) in enumerate(plans):
            m_rows, u_rows, M, U, *_ = plan
            m_idx[i, :M] = self.g_row[m_rows]
            u_idx[i, :U] = self.g_row[u_rows]
            Z1b[i, :M] = zcol[m_rows]
            m_maskb[i, :M] = 1.0
            u_maskb[i, :U] = 1.0
        inputs = (m_idx, u_idx, Z1b, m_maskb, u_maskb)
        if mesh is not None:
            panel, fn = self._mesh_fn("region")
        else:
            panel = self._device_panel()
            fn = self.engine._region_fn(self.pop_sizes, self.wgts)
            inputs = tuple(jnp.asarray(a) for a in inputs)
        plans_out = [(lo, hi, plan, (0, 0)) for lo, hi, plan in plans]
        return plans_out, inputs, (panel,), fn

    def _region_assembly(self, plans):
        """Pass-invariant output skeleton for impute_region: the table
        is immutable after prepare, so everything except the imputed
        z/info values is precomputed once -- emitted row selection,
        static output columns, and the flat scatter indices mapping
        kernel outputs [W, Up] onto emitted rows.  Per pass only the
        value scatter + pval evaluation remain on the timed path."""
        t = self.table
        bp = t["bp"].to_numpy()
        emit = np.zeros(len(t), dtype=bool)
        for lo, hi, plan, _ in plans:
            emit |= (bp >= lo) & (bp <= hi)
        sel = np.flatnonzero(emit)
        win_l, col_l, pos_l = [], [], []
        for i, (lo, hi, plan, (mloc, uloc)) in enumerate(plans):
            u_rows = plan[1]
            U = plan[3]
            win_l.append(np.full(U, i, dtype=np.int64))
            col_l.append(uloc + np.arange(U, dtype=np.int64))
            # u_rows lie inside [lo, hi] => always emitted
            pos_l.append(np.searchsorted(sel, u_rows))
        af_col = "af1mix" if self.wgts is not None else "af1ref"
        tt = t.iloc[sel]
        return {
            "win": np.concatenate(win_l),
            "col": np.concatenate(col_l),
            "pos": np.concatenate(pos_l),
            "base_z": t["z"].to_numpy()[sel],
            "base_info": t["info"].to_numpy()[sel],
            "static": {
                "rsid": tt["rsid"].to_numpy(),
                "chr": tt["chr"].to_numpy(),
                "bp": tt["bp"].to_numpy(),
                "a1": tt["a1"].to_numpy(),
                "a2": tt["a2"].to_numpy(),
                af_col: tt[af_col].to_numpy(),
                "type": tt["type"].to_numpy(),
            },
            "af_col": af_col,
        }

    def impute_region_async(self, start_bp: int, end_bp: int,
                            window_bp: int = 1_000_000,
                            wing_size: int = 500_000
                            ) -> "RegionHandle":
        """Dispatch the region kernel WITHOUT waiting: JAX dispatch is
        asynchronous, so the returned handle's arrays compute on-device
        while the host does other work -- fetch + output assembly for
        region N overlap region N+1's device time when callers keep two
        handles in flight (impute_regions does this; VERDICT r4 item 2:
        nothing overlapped host assembly with device compute before).
        Call .result() for the output frame."""
        if not self.engine.device_linalg:
            raise ValueError("impute_region_async requires device_linalg")
        batch = self._region_batch(start_bp, end_bp, window_bp, wing_size)
        if batch is None:
            return RegionHandle(None, None)
        plans, inputs, panel, fn = batch
        out = fn(*panel, *inputs)          # async dispatch
        ck = ("asm", (start_bp, end_bp, window_bp, wing_size))
        asm = self._res.get(ck)
        if asm is None:
            asm = self._region_assembly(plans)
            self._res[ck] = asm
        return RegionHandle(out, asm)

    def impute_regions(self, spans, window_bp: int = 1_000_000,
                       wing_size: int = 500_000, depth: int = 2):
        """Pipelined multi-region imputation: yields (start_bp, end_bp,
        DataFrame) per span with up to ``depth`` regions in flight --
        region N's host fetch/assembly runs while region N+1 computes
        on the device."""
        from collections import deque
        depth = max(int(depth), 1)      # depth<1 degrades to sequential
        pending: deque = deque()
        for span in spans:
            if len(pending) >= depth:   # cap in-flight handles at depth
                lo0, hi0, h = pending.popleft()
                yield lo0, hi0, h.result()
            lo, hi = span
            pending.append((lo, hi, self.impute_region_async(
                lo, hi, window_bp, wing_size)))
        while pending:
            lo0, hi0, h = pending.popleft()
            yield lo0, hi0, h.result()

    def impute_region(self, start_bp: int, end_bp: int,
                      window_bp: int = 1_000_000,
                      wing_size: int = 500_000) -> pd.DataFrame:
        """Tile [start_bp, end_bp] with non-overlapping prediction windows
        (plus wings) and impute them all.

        On the device path all windows of the region run as ONE
        on-device dispatch (batched-window resident kernel) at a
        unified bucketed (Mp, Up) shape: a single index upload + launch
        + z/info fetch for the whole region instead of one round trip
        per window.  A unified shape also avoids fragmenting
        the batch into per-shape groups that each pay window_bucket
        padding.  Batch inputs live on-device and the output frame
        skeleton is precomputed (_region_assembly), so a steady-state
        pass costs one dispatch + a [W, Up] fetch + a value scatter.
        """
        frames = []
        if self.engine.device_linalg:
            h = self.impute_region_async(start_bp, end_bp, window_bp,
                                         wing_size)
            res = h.result()
            if len(res):
                frames.append(res)
        else:
            lo = start_bp
            while lo <= end_bp:
                hi = min(lo + window_bp - 1, end_bp)
                r = self.impute_window(lo, hi, wing_size)
                if r is not None:
                    frames.append(r.table)
                lo = hi + 1
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)


class RegionHandle:
    """In-flight region imputation (see impute_region_async): holds the
    lazy device output + the precomputed assembly skeleton; .result()
    fetches and assembles (the only blocking step)."""

    __slots__ = ("_out", "_asm", "_frame")

    def __init__(self, out, asm):
        self._out = out
        self._asm = asm
        self._frame = None

    def result(self) -> pd.DataFrame:
        if self._frame is None:
            if self._out is None:
                self._frame = pd.DataFrame()
            else:
                asm = self._asm
                # single-device region kernels return ONE stacked
                # [2, W, Up] array: one dispatch, one fetch; the mesh
                # kernel returns the (z, info) tuple
                if isinstance(self._out, tuple):
                    z = np.asarray(self._out[0])
                    info = np.asarray(self._out[1])
                else:
                    zi = np.asarray(self._out)
                    z, info = zi[0], zi[1]
                self._out = None
                out_z = asm["base_z"].copy()
                out_info = asm["base_info"].copy()
                if z.ndim == 1:
                    # compacted [2, N] fetch: values already in the
                    # assembly's win/col concat order
                    out_z[asm["pos"]] = z.astype(np.float64)
                    out_info[asm["pos"]] = info.astype(np.float64)
                else:
                    out_z[asm["pos"]] = z[asm["win"],
                                          asm["col"]].astype(np.float64)
                    out_info[asm["pos"]] = info[
                        asm["win"], asm["col"]].astype(np.float64)
                cols = dict(asm["static"])
                typ = cols.pop("type")
                cols.update(z=out_z, pval=pnorm_two_sided(out_z),
                            info=out_info, type=typ)
                self._frame = pd.DataFrame(cols, copy=False)
        return self._frame


@dataclasses.dataclass
class PreparedGenes:
    """Gene-grouped join product for engine-resident jepeg/jepegmix.

    Arrays are aligned to the geneid-sorted gene-SNP order; ``spans``
    gives each gene's [start, end) slice and ``panel_rows`` the
    PanelStore row of every gene SNP.  The panel uploads to HBM once
    (per PreparedGenes) and every jepeg_region call gathers gene blocks
    on-device."""

    engine: GenomeEngine
    zs: np.ndarray
    infos: np.ndarray
    rsids: np.ndarray
    gids: np.ndarray
    panel_rows: np.ndarray
    spans: List[Tuple[int, int]]
    gene_min_bp: np.ndarray
    cw_rows: np.ndarray
    cp_rows: np.ndarray
    subj_cols: np.ndarray
    pop_sizes: Tuple[int, ...]
    wgts: Optional[Tuple[float, ...]]
    _G_dev: Optional[jnp.ndarray] = None
    _local_sizes: Optional[Tuple[int, ...]] = None

    def _device_panel(self) -> jnp.ndarray:
        """Selected-population panel in HBM.  With an engine mesh the
        subject axis is re-laid-out for sharding (each shard holds an
        equal slice of every population) and the upload itself is
        sharded over the ``subject`` mesh axis."""
        if self._G_dev is None:
            G = self.engine.store.G
            cols = self.subj_cols
            full = len(cols) == G.shape[1] and bool(
                np.array_equal(cols, np.arange(G.shape[1])))
            Gs = G if full else G[:, cols]
            mesh = self.engine.mesh
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P
                from ..parallel.mesh import subject_shard_layout
                G_layout, _, locs = subject_shard_layout(
                    Gs, self.pop_sizes, mesh.shape["subject"])
                self._local_sizes = locs
                self._G_dev = jax.device_put(
                    G_layout, NamedSharding(mesh, P(None, "subject")))
            else:
                self._G_dev = jnp.asarray(Gs)
        return self._G_dev

    def jepeg_region(self, start_bp: Optional[int] = None,
                     end_bp: Optional[int] = None) -> pd.DataFrame:
        """Gene tests for every gene whose FIRST SNP lies in
        [start_bp, end_bp] (None = unbounded).  Genes are independent
        (reference loops them serially, src/jepegmix.cpp:122-139);
        assigning each gene to the chunk holding its first SNP makes
        chunked genome-wide runs partition the gene set exactly.

        All O(n^2) per-gene math (CorG, CovU, WWt, U) runs batched on
        the device -- sharded over the engine mesh when one is set
        (genes over the ``window`` axis, subjects psum'd) -- and only
        the k<=6 category pruning/chi-square remains on the host."""
        from . import jepeg as jepeg_mod
        lo = -np.inf if start_bp is None else start_bp
        hi = np.inf if end_bp is None else end_bp
        gsel = np.flatnonzero((self.gene_min_bp >= lo)
                              & (self.gene_min_bp <= hi))
        if len(gsel) == 0:
            return jepeg_mod.empty_gene_frame()
        from ..core import genekernels
        spans_sel = [self.spans[i] for i in gsel]
        idx_list = [self.panel_rows[s:e] for s, e in spans_sel]
        sqrt_info = np.sqrt(self.infos)
        Ws = [(self.cw_rows[s:e] * sqrt_info[s:e, None]).T
              for s, e in spans_sel]
        zs = [self.zs[s:e] for s, e in spans_sel]
        panel = self._device_panel()     # sets _local_sizes under a mesh
        stats6 = genekernels.gene_stats_resident(
            panel, idx_list, Ws, zs, self.pop_sizes, self.wgts,
            lam=self.engine.settings.lambda_, mesh=self.engine.mesh,
            local_pop_sizes=self._local_sizes)
        return jepeg_mod.run_gene_tests_stats(
            self.zs, self.rsids, self.gids, spans_sel, stats6,
            self.cp_rows, self.engine.settings)


def _build_corr_blocks_fn(pop_sizes, wgts):
    """Jitted (Gm [M,S], Gu [U,S]) -> (B11 f64 [M,M], B21 f64 [U,M])
    correlation blocks (diagonals NOT ridged; host applies that)."""
    bounds = stats.segment_bounds(pop_sizes)

    if wgts is not None:
        m64 = np.asarray(pop_sizes, dtype=np.float64)
        w64 = np.asarray(wgts, dtype=np.float64)

        @jax.jit
        def fn(Gm, Gu):
            C_mm = stats.pop_cross_products(Gm, Gm, bounds)
            C_um = stats.pop_cross_products(Gu, Gm, bounds)
            S_m, Q_m = stats.pop_row_stats(Gm, bounds)
            S_u, Q_u = stats.pop_row_stats(Gu, bounds)
            var_m = stats.wgt_var_combine(Q_m, S_m, m64, w64)
            var_u = stats.wgt_var_combine(Q_u, S_u, m64, w64)
            std_m = jnp.sqrt(jnp.where(var_m > 0, var_m, 1.0))
            std_u = jnp.sqrt(jnp.where(var_u > 0, var_u, 1.0))
            cov_mm = stats.wgt_cov_combine(C_mm, S_m, S_m, m64, w64)
            cov_um = stats.wgt_cov_combine(C_um, S_u, S_m, m64, w64)
            B11 = cov_mm / (std_m[:, None] * std_m[None, :])
            B21 = cov_um / (std_u[:, None] * std_m[None, :])
            return B11, B21
    else:
        n = float(sum(int(x) for x in pop_sizes))

        @jax.jit
        def fn(Gm, Gu):
            B11 = stats.pooled_corr_matrix(Gm, Gm)
            B21 = stats.pooled_corr_matrix(Gu, Gm)
            return B11, B21

    return fn
