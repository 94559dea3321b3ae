"""The framework's settings registry and its one backend dispatch point.

Every environment variable the package reads is listed in ``REGISTRY`` with
its meaning, default, and WHEN it is read; ``snapshot()`` returns the
currently-effective values (for logging / bench artifacts).

:func:`current_backend` is the build-time backend stamp
``engine.chain.Chain`` validates at render time, and
:func:`use_walk_kernel` is the only place that decides a backend-dependent
execution path.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple


class Setting(NamedTuple):
    name: str
    default: str
    read_time: str   # "import" | "trace" | "start"
    where: str       # module that reads it
    meaning: str


REGISTRY: tuple[Setting, ...] = (
    Setting("JAX_COMPILATION_CACHE_DIR", "<checkout>/.jax_cache", "start",
            "core.settings",
            "JAX's persistent compile cache. When set, JAX uses it as it"
            " stands; otherwise enable_compile_cache() points JAX at the"
            " fixed, gitignored <checkout>/.jax_cache."),
)


def snapshot() -> dict[str, str]:
    """Currently-effective value of every registered setting."""
    return {s.name: os.environ.get(s.name, s.default) for s in REGISTRY}


def current_backend() -> str:
    """The backend that trace-time planning decisions will bake in: the
    platform of ``jax.default_device`` where one is set (so a CPU reference
    can be built and run beside the GPU in one process), else JAX's default
    backend."""
    import jax

    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    if isinstance(dev, str):
        return jax.devices(dev)[0].platform
    return dev.platform


def use_walk_kernel() -> bool:
    """Whether compressor/gate run as the compiled dynamics walk kernel
    (kernels/dynamics_walk.py, Pallas on the Triton route: the GPU) or as
    the serial ``lax.scan`` of ops/dynamics.py (every other backend).

    The two are bit-identical; the kernel exists because a scan costs one
    device loop iteration per sample."""
    return current_backend() == "gpu"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already uses it and nothing
    is changed. Otherwise the cache goes to ``<checkout>/.jax_cache``: a
    fixed path, because the path is part of what makes an entry hit. Call
    before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(Path(__file__).resolve().parents[2] / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
