"""Test environment: 8 virtual CPU devices, float64 enabled.

Must set env before the first jax import anywhere in the test process.
"""
import os

# Force CPU: the suite needs 8 virtual devices + float64, so it always runs
# on the host CPU, also on a machine with a GPU (the GPU path is checked by
# chip_smoke.py, and the tests marked `gpu` skip here).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Force the platform through the config API too, in case jax was imported
# (and read its environment) before this file ran.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib  # noqa: E402

import pytest  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN
