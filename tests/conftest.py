"""Test configuration: the tests run on the CPU backend with 8 virtual
host devices, so sharding paths are exercised without a GPU.  Tests of
code that runs only on the GPU carry the ``gpu`` marker and skip here
(see the ``gpu`` fixture)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# CPU unless the caller names a platform (the GPU tests run with
# JAX_PLATFORMS=cuda, see README)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

import numpy as np
import pytest

import gauss_jax  # noqa: F401  (enables x64)
from gauss_jax.utils import testing as gtest


@pytest.fixture(scope="session")
def synpanel(tmp_path_factory):
    d = tmp_path_factory.mktemp("panel")
    return gtest.make_synthetic_panel(str(d), n_snps=300)


@pytest.fixture(scope="session")
def gwas_input(synpanel, tmp_path_factory):
    d = tmp_path_factory.mktemp("gwas")
    path = str(d / "zinput.txt")
    truth = gtest.make_gwas_input(synpanel, path)
    return path, truth


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (tests marked ``gpu``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")
