"""Reference-panel access: index reading, one-shot genotype decode,
panel writing (for fixtures/conversion).

The reference reads the panel with per-SNP ``bgzf_seek(fpos)`` + parse
loops repeated for every analysis call (reference: src/gauss.cpp:543-872).
Here the panel region is decoded ONCE into columnar arrays:

* ``G``: int8 dosage matrix [num_snps, num_selected_subjects]
* ``af``: float64 allele-frequency matrix [num_snps, num_pops]

which then live in device HBM for the windowed matmul kernels.  Wire
format stays identical to the reference (SURVEY.md section 2.4):

* index (bgzf text):  rsid chr bp a1 a2 af1ref fpos   (fpos = virtual
  offset of the SNP's row in the data file; reference src/gauss.cpp:322-330)
* data (bgzf text): one line per SNP =
  geno_str_pop1 .. geno_str_popP  af1_pop1 .. af1_popP, where
  geno_str_k is a string of '0'/'1'/'2' chars, one per subject
  (reference: src/gauss.cpp:571-585,660-674)
"""

from __future__ import annotations

import io as _io
import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from .bgzf import BgzfReader, BgzfWriter
from .readers import PopDesc


def read_panel_index(
    index_file: str,
    chrom: int = 0,
    start_bp: Optional[int] = None,
    end_bp: Optional[int] = None,
    wing_size: int = 0,
) -> pd.DataFrame:
    """Stream the bgzf panel index into a DataFrame, optionally windowed.

    Mirrors the filtering in ReadReferenceIndex (reference:
    src/gauss.cpp:332-338): keep rows with matching chromosome (when
    chrom > 0) and bp in [start_bp - wing_size, end_bp + wing_size].
    """
    from . import native
    if native.available():
        h = native.NativeBgzf(index_file)
        try:
            text = h.read_all()
        finally:
            h.close()
    else:
        with BgzfReader(index_file, cache_blocks=0) as r:
            text = r.read_all()
    df = pd.read_csv(
        _io.BytesIO(text),
        sep=r"\s+",
        header=None,
        names=["rsid", "chr", "bp", "a1", "a2", "af1ref", "fpos"],
        dtype={"rsid": str, "chr": np.int32, "bp": np.int64, "a1": str,
               "a2": str, "af1ref": np.float64, "fpos": np.int64},
    )
    if chrom > 0:
        df = df[df["chr"] == chrom]
    if start_bp is not None:
        df = df[df["bp"] >= start_bp - wing_size]
    if end_bp is not None:
        df = df[df["bp"] <= end_bp + wing_size]
    return df.reset_index(drop=True)


@dataclass
class DecodedRows:
    """Result of bulk-decoding panel rows for a set of SNPs."""

    G: np.ndarray          # int8 [n_snps, n_selected_subjects]
    af: np.ndarray         # float64 [n_snps, num_pops] per-pop af1
    pop_sizes: np.ndarray  # int64 [n_selected_pops] subject counts per selected pop
    pop_index: np.ndarray  # int64 [n_selected_pops] original pop indices


class PanelReader:
    """Bulk decoder for the bgzf panel data file.

    Uses the native multithreaded decoder (csrc/panel_decoder.cpp via
    gauss_jax.io.native) when the shared library is built, falling back
    to the pure-Python block reader otherwise.
    """

    def __init__(self, data_file: str, desc: PopDesc,
                 use_native: Optional[bool] = None):
        self.data_file = data_file
        self.desc = desc
        if use_native is None:
            from . import native
            use_native = native.available()
        self.use_native = use_native

    def decode_rows(
        self,
        fpos: Sequence[int],
        pop_flags: Optional[np.ndarray] = None,
        want_genotypes: bool = True,
        want_af: bool = True,
    ) -> DecodedRows:
        """Decode the panel rows at the given virtual offsets.

        Rows are visited in sorted-fpos order so each bgzf block is
        inflated exactly once (the reference re-seeks per SNP per call:
        src/gauss.cpp:561,651,744).  Output row order matches the input
        ``fpos`` order.
        """
        if self.use_native:
            return self._decode_rows_native(fpos, pop_flags,
                                            want_genotypes, want_af)
        return self._decode_rows_python(fpos, pop_flags,
                                        want_genotypes, want_af)

    def _decode_rows_native(self, fpos, pop_flags, want_genotypes, want_af
                            ) -> DecodedRows:
        from . import native
        desc = self.desc
        P = desc.num_pops
        if pop_flags is None:
            pop_flags = np.ones(P, dtype=np.int8)
        sel = np.flatnonzero(np.asarray(pop_flags) != 0)
        h = native.NativeBgzf(self.data_file)
        try:
            G, af = h.decode_rows(np.asarray(fpos, dtype=np.int64),
                                  desc.sizes, sel,
                                  want_genotypes=want_genotypes,
                                  want_af=want_af)
        finally:
            h.close()
        return DecodedRows(G=G, af=af,
                           pop_sizes=desc.sizes[sel].astype(np.int64),
                           pop_index=sel.astype(np.int64))

    def _decode_rows_python(
        self,
        fpos: Sequence[int],
        pop_flags: Optional[np.ndarray] = None,
        want_genotypes: bool = True,
        want_af: bool = True,
    ) -> DecodedRows:
        desc = self.desc
        P = desc.num_pops
        if pop_flags is None:
            pop_flags = np.ones(P, dtype=np.int8)
        pop_flags = np.asarray(pop_flags)
        sel = np.flatnonzero(pop_flags != 0)
        sel_sizes = desc.sizes[sel]
        n_sel_subj = int(sel_sizes.sum())

        fpos = np.asarray(fpos, dtype=np.int64)
        n = len(fpos)
        order = np.argsort(fpos, kind="stable")

        G = np.empty((n, n_sel_subj), dtype=np.int8) if want_genotypes else None
        af = np.full((n, P), np.nan, dtype=np.float64) if want_af else None

        with BgzfReader(self.data_file, cache_blocks=4) as r:
            for oi in order:
                r.seek(int(fpos[oi]))
                line = r.readline()
                if line is None:
                    raise IOError(
                        f"panel data file ended before row at fpos {fpos[oi]}")
                self._parse_row(line, oi, sel, G, af)

        return DecodedRows(
            G=G,
            af=af,
            pop_sizes=sel_sizes.astype(np.int64),
            pop_index=sel.astype(np.int64),
        )

    def _parse_row(self, line: bytes, row: int, sel: np.ndarray,
                   G: Optional[np.ndarray], af: Optional[np.ndarray]) -> None:
        parts = line.split()
        desc = self.desc
        P = desc.num_pops
        if len(parts) < 2 * P:
            raise ValueError(
                f"panel data row has {len(parts)} fields, expected {2*P}")
        if G is not None:
            col = 0
            for k in sel:
                s = parts[k]
                m = desc.sizes[k]
                if len(s) != m:
                    raise ValueError(
                        f"genotype string length {len(s)} != pop size {m} "
                        f"for pop index {k}")
                G[row, col:col + m] = np.frombuffer(s, dtype=np.uint8).astype(np.int8) - ord("0")
                col += m
        if af is not None:
            af[row, :] = [float(parts[P + k]) for k in range(P)]


# ---------------------------------------------------------------------------
# Panel writing -- fixture generation and format conversion.
# ---------------------------------------------------------------------------

def write_panel(
    out_prefix: str,
    desc: PopDesc,
    index_df: pd.DataFrame,
    genotypes: np.ndarray,
    afs: Optional[np.ndarray] = None,
) -> Tuple[str, str, str]:
    """Write a panel in the reference wire format.

    Parameters
    ----------
    index_df: columns rsid, chr, bp, a1, a2 (af1ref may be present;
        otherwise computed over ALL pops).  Must be row-aligned with
        ``genotypes``.
    genotypes: int8 [n_snps, total_subjects] dosages, subjects ordered
        by panel population order.
    afs: optional float64 [n_snps, num_pops]; computed from genotypes
        when omitted.

    Returns (index_file, data_file, pop_desc_file).
    """
    n, S = genotypes.shape
    assert S == desc.total_subjects, (S, desc.total_subjects)
    bounds = np.concatenate([[0], np.cumsum(desc.sizes)])
    if afs is None:
        afs = np.stack(
            [genotypes[:, bounds[k]:bounds[k + 1]].mean(axis=1) / 2.0
             for k in range(desc.num_pops)], axis=1)

    data_file = out_prefix + "_geno.gz"
    index_file = out_prefix + "_index.gz"
    pop_desc_file = out_prefix + "_pop_desc.txt"

    # data file first: records each row's virtual offset for the index.
    fpos = np.empty(n, dtype=np.int64)
    digits = (genotypes + ord("0")).astype(np.uint8)
    with BgzfWriter(data_file) as w:
        for i in range(n):
            fields = [digits[i, bounds[k]:bounds[k + 1]].tobytes()
                      for k in range(desc.num_pops)]
            fields += [f"{afs[i, k]:.6g}".encode() for k in range(desc.num_pops)]
            fpos[i] = w.tell()
            w.write(b" ".join(fields) + b"\n")

    # overall af1ref column for the index (not used by readers but part of
    # the format): pooled over all pops.
    if "af1ref" in index_df.columns:
        af1ref = index_df["af1ref"].to_numpy()
    else:
        af1ref = genotypes.mean(axis=1) / 2.0
    with BgzfWriter(index_file) as w:
        for i in range(n):
            row = index_df.iloc[i]
            w.write(
                f"{row.rsid} {row.chr} {row.bp} {row.a1} {row.a2} "
                f"{af1ref[i]:.6g} {fpos[i]}\n".encode())

    with open(pop_desc_file, "w") as fh:
        fh.write("Population_Abbreviation\tNumber_of_Subjects\tSuper_Population\n")
        for p, m, sp in zip(desc.pops, desc.sizes, desc.sup_pops):
            fh.write(f"{p}\t{m}\t{sp}\n")

    return index_file, data_file, pop_desc_file
