"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators by forcing the
host platform to expose 8 devices (the standard JAX trick for testing pjit /
shard_map code paths).  Both ``JAX_PLATFORMS`` and ``jax.config`` are set
before any backend is touched, so the suite runs on the CPU even on a
machine with a GPU.  Tests that need the GPU carry the ``gpu`` marker and
skip here (`chip_smoke.py` runs those paths on the card).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
# Hermetic tests: no persistent compile-cache writes to $HOME (individual
# compile-cache tests re-enable it against tmp paths).
os.environ.setdefault("ECNF_COMPILE_CACHE", "0")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (import after env setup)

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", "tests must run on the CPU mesh"
