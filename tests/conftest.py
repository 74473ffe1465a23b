"""Test configuration: run on CPU with 8 virtual devices and x64.

Multi-chip sharding is validated on a virtual CPU mesh; numerical oracle
tests use float64 for tight tolerances. JAX_PLATFORMS defaults to the CPU;
the tests marked ``gpu`` run on a card with JAX_PLATFORMS=cuda.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
jax.config.update("jax_enable_x64", True)
