"""Test config: run the suite on a deterministic 8-device CPU mesh.

Unless JAX_PLATFORMS says otherwise, the tests run on the CPU backend
with 8 virtual devices — the standard JAX approach for testing N-device
sharding without a cluster (SURVEY.md §4).  jax.config.update is used
because it works even when jax was imported before this file.

Tests that need an NVIDIA GPU carry the `gpu` marker and take the
`gpu_device` fixture, which skips them when JAX's default device is not
a GPU.  Run them on a card, in one process (a JAX process reserves most
of the card's memory), with
    JAX_PLATFORMS=cuda,cpu python -m pytest -p no:xdist -o addopts="" -m gpu tests/
"""

import os

import jax
import pytest

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
# NO persistent compilation cache on the CPU suite (CPU AOT entries are
# machine-feature-pinned).
try:
    jax.config.update("jax_num_cpu_devices", 8)
except AttributeError:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()


@pytest.fixture
def gpu_device():
    """JAX's default device when it is a GPU; skips the test otherwise.
    Decided here, at run time, so every xdist worker collects the same
    tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's device is {dev.platform}")
    return dev


def pytest_collection_modifyitems(items):
    """Run the heaviest-compile files FIRST: the XLA:CPU compiler has
    segfaulted compiling the big RNS programs late in long sessions
    (hundreds of compiled programs in-process), while the same compiles
    succeed in a fresh process.  Front-loading them keeps the suite off
    that cliff; the bucketed decrypt/mul widths (models/paillier.py)
    reduce how many such compiles exist at all."""
    heavy = ("test_parity_2048.py", "test_kat.py", "test_parallel.py",
             "test_rns.py")
    items.sort(key=lambda it: 0 if it.fspath.basename in heavy else 1)
