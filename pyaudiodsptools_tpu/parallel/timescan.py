"""Time-sharded linear recurrences: biquad IIR over a sharded time axis.

The recurrent ops are the one family the baseline sharding strategy gathers
onto each device (sharding.py resharding to P('channel', None)). For *linear*
recurrences there is a better answer — the classic blocked scan
(SURVEY.md §7 hard part #3), here over the mesh's 'time' axis:

1. **halo**: each shard ppermutes its last 3 input samples to its right
   neighbor (the biquad's FIR taps reach 3 samples back, matching the
   reference's PrevOriginalChunkSample state, EffectEQ3Band.py:36-43);
2. **local scan**: each shard runs the affine associative scan on its
   segment, keeping BOTH cumulative products: ``s[n] = A[n] s_in + b[n]``;
3. **carry exchange**: shard summaries (one 2x2 matrix + 2-vector each) are
   all-gathered — bytes, not samples — and each shard folds the prefix of
   summaries before it into its incoming state ``s_in``;
4. **correction**: ``y[n] = (A[n] s_in + b[n])[0]`` — pure local math.

Per-shard work is n/p samples; communication is O(p) tiny matrices plus a
3-sample halo per band, so scaling efficiency stays near-linear. The
nonlinear dynamics automaton has no such decomposition and stays
channel-sharded.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.eq3band import EQ3BandParams


def _band_sharded(coeffs, x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """One biquad band over a time-sharded last axis. ``x``: (..., n_local)."""
    b0, b1, b2, a1, a2 = (coeffs[i] for i in range(5))
    p = jax.lax.psum(1, axis_name)
    t = jax.lax.axis_index(axis_name)

    # 1. halo: last 3 samples to the right neighbor (left edge gets zeros).
    perm = [(i, i + 1) for i in range(p - 1)]
    halo = jax.lax.ppermute(x[..., -3:], axis_name, perm)

    def shift(v, k):
        head = halo[..., 3 - k :]
        return jnp.concatenate([head, v[..., :-k]], axis=-1)

    # FIR forcing term with the reference's 1-sample input delay quirk.
    c = b0 * shift(x, 1) + b1 * shift(x, 2) + b2 * shift(x, 3)

    # 2. local affine scan keeping cumulative (A, b).
    n = c.shape[-1]
    m = jnp.broadcast_to(
        jnp.array([[-a1, -a2], [1.0, 0.0]], dtype=c.dtype), c.shape[:-1] + (n, 2, 2)
    )
    v = jnp.stack([c, jnp.zeros_like(c)], axis=-1)[..., None]

    # f32 matrix products run in full precision: the GPU's default may use
    # TF32 (~3 decimal digits), far below the recurrence's parity bar.
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    def compose(left, right):
        ml, vl = left
        mr, vr = right
        return (mm(mr, ml), mm(mr, vl) + vr)

    a_cum, b_cum = jax.lax.associative_scan(compose, (m, v), axis=m.ndim - 3)

    # 3. summaries -> all-gather -> fold my prefix into s_in.
    a_tot = a_cum[..., -1, :, :]
    b_tot = b_cum[..., -1, :, :]
    a_all = jax.lax.all_gather(a_tot, axis_name)   # (p, ..., 2, 2)
    b_all = jax.lax.all_gather(b_tot, axis_name)   # (p, ..., 2, 1)

    def fold(j, s):
        use = j < t
        s_new = mm(a_all[j], s) + b_all[j]
        return jnp.where(use, s_new, s)

    s0 = jnp.zeros(b_tot.shape, dtype=c.dtype)
    s_in = jax.lax.fori_loop(0, p, fold, s0)

    # 4. correction: purely local.
    y = (mm(a_cum, s_in[..., None, :, :]) + b_cum)[..., 0, 0]
    return y


def eq3band_offline_sharded(params: EQ3BandParams, blocks: jnp.ndarray,
                            mesh: Mesh, axis_name: str = "time") -> jnp.ndarray:
    """Time-sharded equivalent of ``ops.eq3band.offline`` for (C, nb, B)
    blocks sharded P('channel', 'time', None)."""

    spec = P("channel", axis_name, None)

    @partial(shard_map, mesh=mesh, in_specs=(P(None, None), spec),
             out_specs=spec, check_vma=False)
    def run(coeffs, local_blocks):
        shape = local_blocks.shape
        x = local_blocks.reshape(shape[:-2] + (shape[-2] * shape[-1],))
        for band in range(coeffs.shape[0]):
            x = _band_sharded(coeffs[band], x, axis_name)
        return x.reshape(shape).astype(jnp.float32)

    return run(params.coeffs, blocks)
