"""Test harness config: run all tests on a virtual 8-device CPU mesh.

Multi-chip sharding paths are validated here without TPU hardware; bench.py
runs on the real chip. jax may already be partially imported at interpreter
startup in this environment, so we use jax.config (not env vars) to force the
platform.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips elsewhere)")
