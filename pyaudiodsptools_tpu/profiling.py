"""Profiling hooks (SURVEY.md §5 tracing plan).

The reference's profiling is ``time.perf_counter`` prints per effect
(ModuleTests.py:97-105). Here:

* ``annotate_chain`` wraps each op's kernels in ``jax.named_scope`` so
  per-effect cost shows up in XLA profiler traces (TensorBoard,
  ``jax.profiler.trace``).
* ``trace`` is a thin context manager around ``jax.profiler`` writing a
  TensorBoard-compatible trace directory.
"""

from __future__ import annotations

import contextlib

import jax

from .engine.chain import Chain
from .ops.base import Effect


def _wrap(eff: Effect) -> Effect:
    name = eff.name

    def step(params, state, block, _step=eff.step):
        with jax.named_scope(f"effect.{name}.step"):
            return _step(params, state, block)

    offline = None
    if eff.offline is not None:
        def offline(params, blocks, _off=eff.offline):
            with jax.named_scope(f"effect.{name}.offline"):
                return _off(params, blocks)

    return eff._replace(step=step, offline=offline)


def annotate_chain(chain: Chain) -> Chain:
    """A copy of the chain whose ops carry named profiler scopes.

    Fusion is disabled so each op stays a separately scoped program region
    (the point of profiling is per-op attribution; the production chain
    fuses)."""
    return Chain([_wrap(e) for e in chain.effects], fuse=False)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a JAX/XLA profiler trace: ``with profiling.trace('/tmp/tb'):``"""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
