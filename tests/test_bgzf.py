"""BGZF reader/writer roundtrip and virtual-offset tests."""

import gzip

import numpy as np
import pytest

from gauss_jax.io.bgzf import BgzfReader, BgzfWriter, is_bgzf, make_vaddr


def test_roundtrip_lines(tmp_path):
    path = tmp_path / "t.gz"
    lines = [f"line {i} " + "x" * (i % 97) for i in range(5000)]
    vaddrs = []
    with BgzfWriter(path) as w:
        for ln in lines:
            vaddrs.append(w.write((ln + "\n").encode()))
    assert is_bgzf(path)

    with BgzfReader(path) as r:
        # sequential
        got = []
        r.seek(0)
        while True:
            ln = r.readline()
            if ln is None:
                break
            got.append(ln.decode())
        assert got == lines
        # random access by virtual offset
        rng = np.random.default_rng(0)
        for i in rng.integers(0, len(lines), 100):
            r.seek(vaddrs[i])
            assert r.readline().decode() == lines[i]


def test_gzip_compatible(tmp_path):
    """BGZF files are valid multi-member gzip streams."""
    path = tmp_path / "t.gz"
    with BgzfWriter(path) as w:
        w.write(b"hello\nworld\n")
    with gzip.open(path, "rb") as fh:
        assert fh.read() == b"hello\nworld\n"


def test_large_payload_spanning_blocks(tmp_path):
    path = tmp_path / "big.gz"
    big = b"A" * 200_000  # spans multiple 64KB blocks
    with BgzfWriter(path) as w:
        v0 = w.write(big + b"\n")
        v1 = w.write(b"tail\n")
    with BgzfReader(path) as r:
        r.seek(v1)
        assert r.readline() == b"tail"
        r.seek(v0)
        assert r.readline() == big


def test_read_at(tmp_path):
    path = tmp_path / "r.gz"
    data = bytes(range(256)) * 1000
    with BgzfWriter(path) as w:
        w.write(data)
    with BgzfReader(path) as r:
        assert r.read_at(make_vaddr(0, 10), 50) == data[10:60]
