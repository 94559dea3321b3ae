"""Sharded chain rendering over a ('channel', 'time') mesh.

Strategy (SURVEY.md §5 "long-context / sequence parallelism"):

* Block-parallel ops (FFT filters, EQ3BandFFT, waveshapers, tremolo, delay,
  reverb — ``Effect.time_parallel``) run with blocks sharded over BOTH axes:
  ``P('channel', 'time')``. Their shifted-window/shifted-add structure needs
  only neighbor blocks, which GSPMD lowers to collective-permute halo
  exchanges between devices — the framework's ring/CP equivalent.
* Recurrent ops (compressor, gate, biquad EQ — sequential carry over time)
  reshard to ``P('channel', None)``: channels stay distributed (pure DP), time
  is gathered locally so the scan runs at full speed without per-sample
  collectives. The reshard is an all-gather/all-to-all on the time axis.

Equivalence with the single-device render is tested on a virtual 8-device CPU
mesh (tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import block as blk
from ..core.config import EngineConfig
from ..engine.chain import Chain, scan_offline
from ..ops.eq3band import offline as _eq3band_offline


def _gathered_apply(mesh, init_fn, step_fn, offline_fn, p, blocks):
    """Run a channel-gathered (non-time-parallel) op under shard_map.

    Recurrent ops run per-device on their local channel shard. This also
    keeps Pallas kernels (fast/fused dynamics offline) legal on multi-device
    meshes: pallas_call has no GSPMD partitioning rule, but inside shard_map
    it only ever sees the device-local block."""
    spec = P("channel", None, None)
    pspec = jax.tree.map(lambda _: P(), p)

    def local(p, b):
        if offline_fn is not None:
            return offline_fn(p, b)
        return scan_offline(init_fn, step_fn, p, b)

    return jax.shard_map(local, mesh=mesh, in_specs=(pspec, spec),
                         out_specs=spec, check_vma=False)(p, blocks)


def _render_with_constraints(structure, mesh, params, blocks):
    full = NamedSharding(mesh, P("channel", "time", None))
    gathered = NamedSharding(mesh, P("channel", None, None))
    time_sharded = mesh.shape["time"] > 1
    for (init_fn, step_fn, offline_fn, time_parallel), p in zip(structure, params):
        if (time_sharded and offline_fn is _eq3band_offline
                and blocks.ndim == 3):
            # Linear recurrences stay time-sharded via the blocked two-level
            # scan (parallel/timescan.py) instead of gathering time locally.
            from .timescan import eq3band_offline_sharded

            blocks = jax.lax.with_sharding_constraint(blocks, full)
            blocks = eq3band_offline_sharded(p, blocks, mesh)
            continue
        if time_sharded and blocks.ndim == 3:
            # Dynamics automatons (single op or fused cascade) stay
            # time-sharded via the cross-device speculative fixpoint
            # (parallel/dynspec.py) instead of gathering the time axis.
            from .dynspec import dynamics_offline_time_sharded, \
                is_dynamics_params

            if is_dynamics_params(p):
                blocks = jax.lax.with_sharding_constraint(blocks, full)
                blocks = dynamics_offline_time_sharded(p, blocks, mesh)
                continue
        if time_parallel:
            blocks = jax.lax.with_sharding_constraint(blocks, full)
            if offline_fn is not None:
                blocks = offline_fn(p, blocks)
            else:
                blocks = scan_offline(init_fn, step_fn, p, blocks)
        else:
            blocks = jax.lax.with_sharding_constraint(blocks, gathered)
            blocks = _gathered_apply(mesh, init_fn, step_fn, offline_fn,
                                     p, blocks)
    return jax.lax.with_sharding_constraint(
        blocks, NamedSharding(mesh, P("channel", "time", None)))


class ShardedRenderer:
    """Compiled sharded offline renderer for a fixed chain + mesh.

    >>> mesh = make_mesh(channel=4, time=2)
    >>> r = ShardedRenderer(chain, cfg, mesh)
    >>> out = r.render(signal)      # signal: (channels, n)
    """

    def __init__(self, chain: Chain, cfg: EngineConfig, mesh: Mesh):
        self.chain = chain
        self.cfg = cfg
        self.mesh = mesh
        self._structure = tuple(
            (e.init_state, e.step, e.offline, e.time_parallel)
            for e in chain.exec_effects
        )
        self._in_sharding = NamedSharding(mesh, P("channel", "time", None))
        self._fn = jax.jit(partial(_render_with_constraints, self._structure, mesh))

    def render_blocks(self, blocks: jnp.ndarray) -> jnp.ndarray:
        """blocks: (channels, num_blocks, block_size); channels % mesh
        channel-axis == 0 and num_blocks % mesh time-axis == 0."""
        blocks = jax.device_put(blocks, self._in_sharding)
        return self._fn(self.chain.params, blocks)

    def render(self, signal) -> jnp.ndarray:
        signal = jnp.asarray(signal)
        if signal.ndim != 2:
            raise ValueError("sharded render expects (channels, n) audio")
        nb_pad = self.mesh.shape["time"] * self.cfg.block_size
        n = signal.shape[-1]
        pad = (-n) % nb_pad
        if pad:
            signal = jnp.pad(signal, ((0, 0), (0, pad)))
        blocks = blk.make_blocks(signal, self.cfg.block_size)
        out = self.render_blocks(blocks)
        return blk.combine_blocks(out)
