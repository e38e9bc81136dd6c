"""Test configuration: run JAX on CPU with 8 virtual devices and float64.

The multi-chip sharding tests use an 8-device CPU mesh
(xla_force_host_platform_device_count), mirroring how the driver validates
the multi-chip path; numeric tests need x64 for golden-value parity with the
reference's double-precision CTest numbers.  The platform is pinned to
the CPU here even on a machine with a GPU; the `gpu`-marked tests run their
check in a child process.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from parelag_tpu.utils.compile_cache import (  # noqa: E402
    enable_persistent_compile_cache)

enable_persistent_compile_cache()

assert len(jax.devices()) == 8, jax.devices()
