"""Test config: run everything on a virtual 8-device CPU mesh.

Must run before any jax import in the test process.  The Triton band
kernel runs through the Pallas interpreter in these tests
(``interpret=True``); tests that need the card are marked ``gpu`` and
skip here (``python chip_smoke.py`` runs them on the GPU).  A process
that already initialised JAX on a GPU (chip_smoke.py) keeps it: the
platform variable is only a default.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from hcspmm_tpu.graphs import io  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def small_graph(n=100, deg=6, seed=0, span=16, symmetric=True):
    src, dst, nn = io.synthetic_graph(n, deg, seed=seed, span=span, symmetric=symmetric)
    rp, ci = io.to_csr(src, dst, nn)
    return rp, ci, nn


@pytest.fixture
def graph():
    return small_graph()


@pytest.fixture
def gpu():
    """The GPU device, or a skip when JAX has none (decided at run time,
    never at import: every xdist worker must collect the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform: {dev.platform})")
    return dev
