"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding correctness is validated on XLA's host platform with 8 virtual
devices; the multi-card path runs on the GPU through
``chip_smoke.py --four-cards``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFDIR = "/root/reference/Benchmark"


@pytest.fixture(scope="session")
def vela_polyco():
    from dspsr_jax.timing.polyco import Polyco
    return Polyco.load(os.path.join(REFDIR, "vela.polyco"))


@pytest.fixture(scope="session")
def vela_par():
    from dspsr_jax.timing.par import Ephemeris
    return Ephemeris.load(os.path.join(REFDIR, "vela.par"))


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
