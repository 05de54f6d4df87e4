"""Test config: run JAX on a virtual 8-device CPU mesh so sharding
tests work without accelerators, and keep runs deterministic. The
device path's checks on a real GPU live in chip_smoke.py."""

import os

# Run all tests on a virtual 8-device CPU mesh, even where a GPU is
# present: set the env var and also the jax config before any backend
# is initialized.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
