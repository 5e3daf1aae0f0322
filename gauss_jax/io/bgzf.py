"""BGZF (blocked gzip) reader/writer with virtual offsets.

Reimplementation of the reference's C BGZF layer
(reference: src/bgzf.c, src/bgzf.h).  The reference exposes a
character-at-a-time streaming API (``bgzf_getc``/``bgzf_seek``) built
around 64KB compressed blocks addressed by *virtual offsets*::

    vaddr = (compressed_block_start << 16) | within_block_offset

(reference: src/bgzf.h:108,118).  We keep the same wire format and
virtual-offset semantics -- panel index files store ``fpos`` virtual
offsets (reference: src/gauss.cpp:322-330) -- but replace the per-SNP
seek/getc loops with bulk block decoding: the device pipeline decodes a
whole panel region once into columnar arrays instead of re-seeking per
row (see gauss_jax/io/panel.py).

This module is deliberately dependency-free (zlib only) so the file
format works everywhere; the hot decode path for huge panels can use
the optional C++ extension in csrc/ when built.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from dataclasses import dataclass
from typing import BinaryIO, Iterator, List, Optional, Tuple

# BGZF constants (same values as reference src/bgzf.c)
BGZF_BLOCK_SIZE = 0xFF00  # uncompressed payload target per block
BGZF_MAX_BLOCK_SIZE = 0x10000  # 64KB
# gzip header with BGZF "BC" extra field; BSIZE filled in at write time.
_BGZF_HEADER_FMT = struct.Struct("<BBBBIBBHBBHH")
_GZIP_MAGIC = b"\x1f\x8b"

# 28-byte EOF sentinel block (empty BGZF block), identical to htslib/reference.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def make_vaddr(coffset: int, uoffset: int) -> int:
    """Pack (compressed block start, within-block offset) into a virtual offset."""
    return (coffset << 16) | uoffset


def split_vaddr(vaddr: int) -> Tuple[int, int]:
    return vaddr >> 16, vaddr & 0xFFFF


class BgzfError(RuntimeError):
    pass


def _read_block_at(raw: BinaryIO, coffset: int) -> Tuple[bytes, int]:
    """Read and inflate one BGZF block starting at compressed offset.

    Returns (uncompressed payload, compressed block length). Raises
    BgzfError on malformed blocks.
    """
    raw.seek(coffset)
    header = raw.read(18)
    if len(header) == 0:
        return b"", 0
    if len(header) < 18 or header[:2] != _GZIP_MAGIC:
        raise BgzfError(f"bad BGZF block header at offset {coffset}")
    xlen = struct.unpack_from("<H", header, 10)[0]
    extra = header[12:18]
    # Find the BC subfield to get BSIZE (total block size - 1).
    bsize = None
    extra_full = extra + raw.read(max(0, xlen - 6))
    i = 0
    while i + 4 <= len(extra_full):
        si1, si2, slen = extra_full[i], extra_full[i + 1], struct.unpack_from("<H", extra_full, i + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            bsize = struct.unpack_from("<H", extra_full, i + 4)[0]
            break
        i += 4 + slen
    if bsize is None:
        raise BgzfError(f"BGZF BC subfield missing at offset {coffset}")
    block_len = bsize + 1
    # layout: 12-byte fixed header + XLEN extra + cdata + 8-byte footer
    cdata_len = block_len - 12 - xlen - 8
    raw.seek(coffset + 12 + xlen)
    cdata = raw.read(cdata_len)
    footer = raw.read(8)
    if len(cdata) != cdata_len or len(footer) != 8:
        raise BgzfError(f"truncated BGZF block at offset {coffset}")
    isize = struct.unpack_from("<I", footer, 4)[0]
    payload = zlib.decompress(cdata, wbits=-15)
    if len(payload) != isize:
        raise BgzfError(f"BGZF ISIZE mismatch at offset {coffset}")
    return payload, block_len


class BgzfReader:
    """Random-access reader over a BGZF file with a block cache.

    Mirrors the reference's ``bgzf_open/seek/getc`` usage
    (reference: src/bgzf.c:438-478 block cache; src/util.cpp:488-507
    line reader) with a Python-level LRU block cache.
    """

    def __init__(self, path: str | os.PathLike, cache_blocks: int = 64):
        self._fh = open(path, "rb")
        self._cache: dict[int, Tuple[bytes, int]] = {}
        self._cache_order: List[int] = []
        self._cache_blocks = cache_blocks
        self._coffset = 0  # current block compressed offset
        self._uoffset = 0  # offset within current block
        self._block: bytes = b""
        self._block_clen = 0
        self._load_block(0)

    # -- block management -------------------------------------------------
    def _load_block(self, coffset: int) -> None:
        hit = self._cache.get(coffset)
        if hit is None:
            payload, clen = _read_block_at(self._fh, coffset)
            if self._cache_blocks > 0:
                self._cache[coffset] = (payload, clen)
                self._cache_order.append(coffset)
                if len(self._cache_order) > self._cache_blocks:
                    old = self._cache_order.pop(0)
                    self._cache.pop(old, None)
        else:
            payload, clen = hit
        self._coffset = coffset
        self._block = payload
        self._block_clen = clen
        self._uoffset = 0

    # -- public API -------------------------------------------------------
    def seek(self, vaddr: int) -> None:
        """Seek to a virtual offset (reference: bgzf_seek, src/bgzf.h:118)."""
        coffset, uoffset = split_vaddr(vaddr)
        if coffset != self._coffset or not self._block:
            self._load_block(coffset)
        self._uoffset = uoffset

    def tell(self) -> int:
        return make_vaddr(self._coffset, self._uoffset)

    def _advance_block(self) -> bool:
        """Load the next non-empty block; skips empty blocks (e.g. the
        EOF sentinel) iteratively.  Returns False at physical EOF."""
        while True:
            nxt = self._coffset + self._block_clen
            payload, clen = _read_block_at(self._fh, nxt)
            if clen == 0:
                return False
            self._coffset, self._block, self._block_clen = nxt, payload, clen
            self._uoffset = 0
            if payload:
                return True

    def readline(self) -> Optional[bytes]:
        """Read a text line from the current virtual position.

        Equivalent to the reference's BgzfGetLine (src/util.cpp:488-507).
        Returns None at EOF; the trailing newline is stripped.
        """
        parts: List[bytes] = []
        while True:
            if self._uoffset >= len(self._block):
                if not self._advance_block():
                    if parts:
                        break
                    return None
            idx = self._block.find(b"\n", self._uoffset)
            if idx == -1:
                parts.append(self._block[self._uoffset:])
                if not self._advance_block():
                    break
            else:
                parts.append(self._block[self._uoffset:idx])
                self._uoffset = idx + 1
                break
        return b"".join(parts)

    def read_at(self, vaddr: int, size: int) -> bytes:
        """Read exactly ``size`` bytes starting at a virtual offset."""
        self.seek(vaddr)
        out = bytearray()
        while len(out) < size:
            if self._uoffset >= len(self._block):
                if not self._advance_block():
                    break
            take = min(size - len(out), len(self._block) - self._uoffset)
            out += self._block[self._uoffset:self._uoffset + take]
            self._uoffset += take
        return bytes(out)

    def read_all(self) -> bytes:
        """Decode the whole file from virtual position 0.

        The bulk path: every block is inflated exactly once, in file
        order (mirrors the native decoder's NativeBgzf.read_all).
        """
        self.seek(0)
        chunks: List[bytes] = [self._block[self._uoffset:]]
        self._uoffset = len(self._block)
        while self._advance_block():
            chunks.append(self._block)
            self._uoffset = len(self._block)
        return b"".join(chunks)

    def iter_lines(self) -> Iterator[Tuple[int, bytes]]:
        """Iterate (virtual offset of line start, line bytes) from position 0.

        This is the bulk-decode path: each block is inflated once.
        """
        self.seek(0)
        while True:
            vaddr = self.tell()
            line = self.readline()
            if line is None:
                return
            yield vaddr, line

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfWriter:
    """BGZF writer producing reference-compatible files.

    Needed both for the synthetic-panel fixture generator (the reference
    ships no tests; see SURVEY.md section 4) and for users converting
    panels into the reference wire format.
    """

    def __init__(self, path: str | os.PathLike, level: int = 6):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._level = level
        self._coffset = 0

    def tell(self) -> int:
        """Virtual offset of the next byte to be written."""
        return make_vaddr(self._coffset, len(self._buf))

    def write(self, data: bytes) -> int:
        vaddr = self.tell()
        self._buf += data
        while len(self._buf) >= BGZF_BLOCK_SIZE:
            self._flush_block(self._buf[:BGZF_BLOCK_SIZE])
            del self._buf[:BGZF_BLOCK_SIZE]
        return vaddr

    def _flush_block(self, payload: bytes) -> None:
        comp = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = comp.compress(payload) + comp.flush()
        xlen = 6
        # total block = 12 + xlen + len(cdata) + 8; BSIZE = total - 1
        bsize = len(cdata) + 12 + xlen + 8 - 1
        if bsize >= BGZF_MAX_BLOCK_SIZE:
            # incompressible payload: store-level fallback
            comp = zlib.compressobj(0, zlib.DEFLATED, -15)
            cdata = comp.compress(payload) + comp.flush()
            bsize = len(cdata) + 12 + xlen + 8 - 1
        header = struct.pack(
            "<BBBBIBBHBBHH",
            0x1F, 0x8B, 8, 4,  # gzip magic, deflate, FEXTRA
            0, 0, 0xFF,        # mtime, xfl, os
            xlen, 0x42, 0x43, 2, bsize,
        )
        footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
        blob = header + cdata + footer
        self._fh.write(blob)
        self._coffset += len(blob)

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def is_bgzf(path: str | os.PathLike) -> bool:
    with open(path, "rb") as fh:
        head = fh.read(18)
    return (
        len(head) >= 18
        and head[:2] == _GZIP_MAGIC
        and head[3] == 4
        and head[12:14] == b"BC"
    )
