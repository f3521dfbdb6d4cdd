"""Test configuration: force an 8-device virtual CPU mesh so sharding
tests run anywhere. Tests marked `gpu` take the `gpu` fixture, which
skips them unless JAX computes on an NVIDIA GPU (chip_smoke.py runs
them on the card)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import pytest

DATA = pathlib.Path(__file__).parent / "data"
GOLD = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA


@pytest.fixture(scope="session")
def golden_dir() -> pathlib.Path:
    return GOLD


@pytest.fixture(scope="session")
def toy_index():
    """The toy-genome index, loaded once per session (from the committed
    reference-built golden files)."""
    from dart_tpu.index import load_index

    return load_index(str(GOLD / "index" / "toy"))


@pytest.fixture
def gpu():
    """The GPU a `gpu`-marked test computes on. Whether there is one is
    decided here, when the test runs, never while modules are imported:
    every pytest-xdist worker must collect the same tests."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX computes on {dev.platform}); "
                    "run `python chip_smoke.py` on the card")
    return dev
