"""Test configuration: tests run on the 8-device virtual CPU mesh, and key
generation is cached across tests."""
import os

# CPU unless the caller names a platform (the gpu-marked tests run with
# JAX_PLATFORMS=cuda,cpu).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import functools

import pytest

import jax

import tfhe_tpu as tt
from tfhe_tpu.config import enable_compile_cache

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@functools.lru_cache(maxsize=None)
def _cached_keys(params, seed):
    return tt.keygen(params, seed=seed)


@pytest.fixture(scope="session")
def toy_keys():
    return _cached_keys(tt.PARAMS_TOY, (314, 1592, 657))


@pytest.fixture(scope="session")
def small_keys():
    return _cached_keys(tt.PARAMS_SMALL, (314, 1592, 657))


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided here, at test
    time, never while a module is imported."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu)")
