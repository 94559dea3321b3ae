"""Cross-device speculative dynamics: keep compressor/gate TIME-sharded.

The dynamics automaton (ops/dynamics.py; reference semantics
EffectCompressor.py:68-124 / EffectGate.py:69-126) is sequential in time, so
a time-sharded mesh previously had to all-gather the time axis and run it
per-channel (parallel/sharding.py routed it through the channel-gathered
path). This module extends the single-device speculative-segment idea
(kernels/dynamics_walk.py) ACROSS the mesh's 'time' axis:

  * every device walks its local time segment from a guessed entry state
    (initially REST — the all-zeros state);
  * exit states hop to the next device with ``lax.ppermute``;
  * repeat until the entry states reach their global fixpoint (detected with
    a psum'd changed-flag), which reproduces the exact serial trajectory —
    the automaton's state is a few small ints per channel, so each round
    moves only O(channels) bytes between devices.

Convergence is <= n_time rounds worst case, and 2-3 on real audio because
the automaton synchronizes (any completed attack or release forces a state
independent of the entry guess). The loop's last round computes its output
from the already-converged entries, so the result is bit-identical to the
single-device render (tests/test_dynspec.py asserts exact equality).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import dynamics as dyn
from ..ops.dynamics import DynamicsParams


def is_dynamics_params(p) -> bool:
    """True for one DynamicsParams or a (fused-cascade) tuple of them."""
    if isinstance(p, DynamicsParams):
        return True
    return (isinstance(p, tuple) and len(p) > 0
            and all(isinstance(q, DynamicsParams) for q in p))


def _as_list(params):
    return list(params) if isinstance(params, tuple) else [params]


def _local_sweep_fn(interpret: bool):
    """Per-device sweep primitive: (params list, entry state dicts, local
    (C, T) signal) -> (exit state dicts, output), op j+1 consuming op j's
    output. Where core.settings.use_walk_kernel() says so (or with
    ``interpret=True``, which runs the kernel in Pallas interpret mode for
    CPU tests), the segment-parallel walk kernel; elsewhere the faithful
    scans. The two are bit-identical (tests/test_kernels.py)."""
    from ..core.settings import use_walk_kernel

    if interpret or use_walk_kernel():
        from ..kernels.dynamics_walk import (decode_state, encode_state,
                                             walk_offline)

        def sweep(params_list, entries, x):
            e = jnp.stack([encode_state(p, st)
                           for p, st in zip(params_list, entries)])
            out, z, _ = walk_offline(params_list, x, entry=e,
                                     interpret=interpret)
            return tuple(decode_state(p, z[j])
                         for j, p in enumerate(params_list)), out

        return sweep

    def sweep(params_list, entries, x):
        exits = []
        out = x
        for p, st in zip(params_list, entries):
            st, out = dyn.step(p, st, out)
            exits.append(st)
        return tuple(exits), out

    return sweep


def dynamics_offline_time_sharded(params, blocks: jnp.ndarray,
                                  mesh: Mesh,
                                  interpret: bool = False) -> jnp.ndarray:
    """Time-sharded offline dynamics (single op or fused cascade).

    blocks: (C, nb, B) laid out P('channel', 'time', None) on ``mesh``;
    returns the same layout. Must be called under jit (ShardedRenderer does).
    ``interpret=True`` runs the walk kernel in Pallas interpret mode (CPU
    tests of the kernel-inside-shard_map composition).
    """
    n_time = mesh.shape["time"]
    sweep = _local_sweep_fn(interpret)

    def local(params, b):
        params_list = _as_list(params)
        C, nb_loc, B = b.shape
        x = b.reshape(C, nb_loc * B)
        t = jax.lax.axis_index("time")
        e0 = tuple(dyn.init_state(p, (C,)) for p in params_list)
        perm = [(i, i + 1) for i in range(n_time - 1)]

        def body(carry):
            e, _, it, _ = carry
            z, out = sweep(params_list, e, x)
            # device i's exit becomes device i+1's entry; device 0 keeps the
            # true initial state (REST — ppermute's zero-fill equals it, but
            # the where() keeps correctness independent of that encoding).
            zn = jax.tree.map(
                lambda a: jax.lax.ppermute(a, "time", perm), z)
            en = jax.tree.map(
                lambda new, init: jnp.where(t == 0, init, new), zn, e0)
            moved = jax.tree.reduce(
                jnp.logical_or,
                jax.tree.map(lambda a, b2: jnp.any(a != b2), en, e),
            )
            changed = jax.lax.psum(moved.astype(jnp.int32), "time") > 0
            return en, out, it + 1, changed

        def cond(carry):
            _, _, it, changed = carry
            return jnp.logical_and(changed, it < n_time + 1)

        carry = (e0, jnp.zeros_like(x), jnp.int32(0), jnp.bool_(True))
        _, out, _, _ = jax.lax.while_loop(cond, body, carry)
        return out.reshape(C, nb_loc, B)

    pspec = jax.tree.map(lambda _: P(), params)
    spec = P("channel", "time", None)
    return jax.shard_map(local, mesh=mesh, in_specs=(pspec, spec),
                         out_specs=spec, check_vma=False)(params, blocks)
