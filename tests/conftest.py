"""Test configuration: tests run on the CPU with a virtual 8-device mesh
(SURVEY.md §4.3), so sharding/halo logic is tested without a multi-device
machine.

``PADT_TEST_PLATFORM=gpu`` runs the same suite with the GPU as the default
backend (and the CPU beside it); the tests marked ``gpu``
(tests/test_gpu_lane.py) need it and skip without a card.
"""

import os

_platform = os.environ.get("PADT_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = "cuda,cpu" if _platform == "gpu" else _platform
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
