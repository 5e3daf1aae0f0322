"""Native C++ decoder vs pure-Python decoder equivalence."""

import numpy as np
import pytest

from gauss_jax.io import native
from gauss_jax.io.panel import PanelReader, read_panel_index


@pytest.fixture
def native_lib():
    """The decoder builds from csrc/ at first use; skip only when no
    C++ toolchain can build it."""
    if not native.available():
        pytest.skip("native panel decoder could not be built")


def test_native_matches_python(synpanel, native_lib):
    idx = read_panel_index(synpanel.files.index_file)
    rng = np.random.default_rng(9)
    rows = rng.permutation(len(idx))[:80]
    fpos = idx["fpos"].to_numpy()[rows]
    flags = np.array([1, 0, 1, 1, 0], dtype=np.int8)

    py = PanelReader(synpanel.files.data_file, synpanel.desc,
                     use_native=False).decode_rows(fpos, pop_flags=flags)
    nat = PanelReader(synpanel.files.data_file, synpanel.desc,
                      use_native=True).decode_rows(fpos, pop_flags=flags)
    np.testing.assert_array_equal(py.G, nat.G)
    np.testing.assert_allclose(py.af, nat.af, rtol=1e-12)
    np.testing.assert_array_equal(py.pop_index, nat.pop_index)


def test_native_read_all(synpanel, native_lib):
    from gauss_jax.io.bgzf import BgzfReader
    h = native.NativeBgzf(synpanel.files.index_file)
    text = h.read_all()
    h.close()
    chunks = []
    with BgzfReader(synpanel.files.index_file, cache_blocks=0) as r:
        while True:
            ln = r.readline()
            if ln is None:
                break
            chunks.append(ln)
    assert text == b"\n".join(chunks) + b"\n"


def test_native_af_only(synpanel, native_lib):
    idx = read_panel_index(synpanel.files.index_file)
    nat = PanelReader(synpanel.files.data_file, synpanel.desc,
                      use_native=True).decode_rows(
        idx["fpos"].to_numpy(), want_genotypes=False)
    assert nat.G is None
    np.testing.assert_allclose(nat.af, synpanel.afs, atol=5e-7)
