"""The effect-op protocol.

The reference models effects as Python objects with mutable inter-chunk state
mutated by ``.apply(chunk)`` (e.g. EffectFFTFilter.py:49-75). That shape is
hostile to jit/scan/shard, so this framework uses the idiomatic JAX form
(SURVEY.md §7):

    effect: (params, state, block) -> (state, block)

* ``params`` — static pytree built once from an :class:`EngineConfig` (filter
  spectra, envelope ramps, ...). Never mutated.
* ``state`` — explicit pytree carried across blocks (input history windows,
  envelope counters, delay tails, LFO phase). What the reference keeps in
  ``self.*`` attributes lives here, so a chain's whole state can be scanned,
  checkpointed, donated, and sharded.
* ``block`` — ``(..., block_size)``; leading axes are channel batch dims.

Each op may additionally provide an ``offline`` fast path that maps whole
``(..., num_blocks, block_size)`` signals at once — the block-parallel
formulation (batched FFT windows, shifted-adds, closed-form LFO) that gives the
accelerator its throughput; ``offline`` must produce bit-equivalent results to folding
``step`` over the block axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import jax


def pytree_dataclass(cls=None, *, meta_fields: tuple[str, ...] = ()):
    """Register a frozen dataclass as a JAX pytree.

    ``meta_fields`` are static (hashed into the jit cache key); all other
    fields are array leaves.
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = tuple(
            f.name for f in dataclasses.fields(c) if f.name not in meta_fields
        )
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=tuple(meta_fields)
        )
        return c

    return wrap if cls is None else wrap(cls)


class Effect(NamedTuple):
    """A bound effect: params plus its pure functions.

    ``init_state(batch_shape) -> state`` builds the zero state, with leading
    ``batch_shape`` channel axes so one Effect serves any channel count.
    ``step(params, state, block) -> (state, out)`` is the streaming kernel.
    ``offline(params, blocks) -> blocks`` (optional) is the block-parallel
    whole-signal kernel; None means the engine scans ``step``.
    """

    name: str
    params: Any
    init_state: Callable[..., Any]
    step: Callable[[Any, Any, jax.Array], tuple[Any, jax.Array]]
    offline: Optional[Callable[[Any, jax.Array], jax.Array]] = None
    # Whether the offline path is block-parallel along time (FIR windows,
    # shifted adds, closed-form LFO: shardable over a 'time' mesh axis with
    # halo exchange) or carries a sequential recurrence (scan ops: shard
    # channels only). Drives sharding constraints in parallel.render.
    time_parallel: bool = True
    # For linear time-invariant ops: the host-side (numpy float64) effective
    # impulse response INCLUDING the op's latency shift, so that the op equals
    # ``y = conv(x, lti_kernel)`` truncated to input length. Consecutive LTI
    # ops in a Chain fuse into one segmented convolution (engine/chain.py).
    lti_kernel: Optional[Any] = None

    def state(self, batch_shape: tuple[int, ...] = ()) -> Any:
        return self.init_state(self.params, batch_shape)

    def __call__(self, state: Any, block: jax.Array) -> tuple[Any, jax.Array]:
        return self.step(self.params, state, block)
