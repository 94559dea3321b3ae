"""The compressor/gate automaton as one GPU kernel: the dynamics "walk".

The faithful implementation (ops/dynamics.py) is a ``lax.scan`` with one
device loop iteration per sample. This module runs the identical automaton
(or a cascade of them) inside ONE Pallas kernel on the Triton route: the
signal is laid out time-major ``(L, R)`` with one independent lane per
(segment, channel) pair, each program of the grid owns a block of lanes, and
a ``fori_loop`` over the L time rows keeps every lane's state in registers.
Each time row is one coalesced load and one coalesced store.

Lanes are made independent by speculative segmentation. The over-threshold
mask depends only on the input, never on the automaton's own output, so the
whole gain trajectory of a segment is a function of (entry state, input):
split time into G segments, walk every segment from a guessed entry state,
hand each segment's exit state to the next segment's entry, and repeat until
the entries stop changing. The fixpoint is the serial trajectory exactly:
segment g's entry is exact once the exits of segments 0..g-1 are, so the loop
ends within G sweeps, and the automaton *synchronizes* (a completed attack
or release forces a state independent of the entry) so real audio converges
in 2-3.

Gains are read from the same float32 ramp tables the scan gathers
(``attack_env`` followed by ``release_env``), so the walk's output and exit
states are bit-identical to the scan's, cascades included
(tests/test_walk_kernel.py).

The automaton is derived in ops/dynamics.py's module docstring (parity
target EffectCompressor.py:68-124 and EffectGate.py:69-126 of the reference).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..ops import dynamics as dyn
from ..ops.base import Effect
from ..ops.dynamics import ATTACK, HOLD, RELEASE, REST, DynamicsParams

# Lanes per program: one lane per thread at 4 warps.
LANE_BLOCK = 128
# Time rows loaded ahead of their use in the walk, so that K loads are in
# flight together instead of one load latency per sample.
ROWS_AHEAD = 8
# Parallel lanes the offline walk aims for (channels x segments), and the
# shortest segment it accepts.
TARGET_LANES = 32768
MIN_SEGMENT = 1024

# The state of one lane is one int32:
#   s = -1            skip (the reference's double counter increment)
#   s = 0             REST
#   s in [1, x_max)   ATTACK, x == s
#   s = x_max         HOLD
#   s = x_max + y     RELEASE, y in [1, y_max)
# With the gain table attack_env ++ release_env, the ramp gain of a state
# s > 0 is table[s] in ATTACK, HOLD and RELEASE alike.


def encode_state(params: DynamicsParams, state) -> jnp.ndarray:
    """Pack the dict carry (ops/dynamics.init_state layout) into one int."""
    mode, x, y = state["mode"], state["x"], state["y"]
    s = jnp.where(mode == ATTACK, x,
                  jnp.where(mode == HOLD, params.x_max,
                            jnp.where(mode == RELEASE, params.x_max + y, 0)))
    return jnp.where(state["skip"], -1, s).astype(jnp.int32)


def decode_state(params: DynamicsParams, s: jnp.ndarray) -> dict:
    """Inverse of :func:`encode_state` on every reachable state."""
    x_max = params.x_max
    mode = jnp.where(s <= 0, REST,
                     jnp.where(s < x_max, ATTACK,
                               jnp.where(s == x_max, HOLD, RELEASE)))
    return {
        "mode": mode.astype(jnp.int32),
        "x": jnp.where((s > 0) & (s <= x_max), s, 0).astype(jnp.int32),
        "y": jnp.where(s > x_max, s - x_max, 0).astype(jnp.int32),
        "skip": s < 0,
    }


def _gain_table(params_list) -> tuple[jnp.ndarray, tuple[int, ...]]:
    """All ops' ramp tables in one flat float32 array, and each op's offset."""
    tables, offsets, o = [], [], 0
    for p in params_list:
        tables += [p.attack_env.astype(jnp.float32),
                   p.release_env.astype(jnp.float32)]
        offsets.append(o)
        o += p.x_max + p.y_max
    return jnp.concatenate(tables), tuple(offsets)


def _walk_kernel(statics, n_rows, scal_ref, tab_ref, x_ref, e_ref,
                 out_ref, z_ref):
    """Walk n_rows samples of one block of lanes through the op cascade:
    op j+1 consumes op j's per-sample output."""
    ops = []
    for j, (x_max, end, off) in enumerate(statics):
        ops.append((scal_ref[j, 0], scal_ref[j, 1], tab_ref[off + x_max - 1],
                    x_max, end, off))

    def sample(t, row, states):
        new = []
        for (thr, pre, ratio, x_max, end, off), s in zip(ops, states):
            over = jnp.abs(row) > thr
            pos = s > 0
            in_att = pos & (s < x_max)
            ramp = tab_ref[off + jnp.maximum(s, 0)]
            gain = jnp.where(pos, jnp.where(in_att | ~over, ramp, ratio), 1.0)
            sp1 = s + 1
            rel_next = jnp.where(sp1 == end, -1, sp1)   # release done: skip
            hi_next = jnp.where(over, x_max, rel_next)  # hold / re-trigger
            n = jnp.where(in_att, sp1, hi_next)         # attack ignores mask
            n = jnp.where(s == 0, over.astype(jnp.int32), n)  # REST trigger
            new.append(jnp.where(s < 0, 0, n))          # skip consumes itself
            row = row * pre * gain
        out_ref[t, :] = row
        return tuple(new)

    def body(i, states):
        t0 = i * ROWS_AHEAD
        rows = [x_ref[t0 + k, :] for k in range(ROWS_AHEAD)]
        for k, row in enumerate(rows):
            states = sample(t0 + k, row, states)
        return states

    states = tuple(e_ref[j, :] for j in range(len(ops)))
    states = jax.lax.fori_loop(0, n_rows // ROWS_AHEAD, body, states)
    for t in range(n_rows - n_rows % ROWS_AHEAD, n_rows):  # static tail
        states = sample(t, x_ref[t, :], states)
    for j, s in enumerate(states):
        z_ref[j, :] = s


def walk(params_list, xk: jnp.ndarray, entries: jnp.ndarray,
         interpret: bool = False):
    """One pass of the kernel: time-major ``xk`` (L, R) from per-lane entry
    states ``entries`` (n_ops, R) -> (output (L, R), exit states (n_ops, R)).

    Lanes are padded to the lane block internally; padded lanes are
    independent and dropped."""
    params_list = list(params_list)
    n_ops = len(params_list)
    L, R = xk.shape
    lane_block = min(LANE_BLOCK, max(16, pl.next_power_of_2(R)))
    Rp = -(-R // lane_block) * lane_block
    xk = jnp.pad(xk, ((0, 0), (0, Rp - R)))
    entries = jnp.pad(entries.astype(jnp.int32), ((0, 0), (0, Rp - R)))
    table, offsets = _gain_table(params_list)
    scal = jnp.stack([jnp.stack([p.threshold.astype(jnp.float32),
                                 p.pre_gain.astype(jnp.float32)])
                      for p in params_list])
    statics = tuple((p.x_max, p.x_max + p.y_max, o)
                    for p, o in zip(params_list, offsets))

    lanes = lambda i: (0, i)
    whole = lambda i: (0, 0)
    out, z = pl.pallas_call(
        partial(_walk_kernel, statics, L),
        grid=(Rp // lane_block,),
        in_specs=[
            pl.BlockSpec((n_ops, 2), whole),
            pl.BlockSpec(table.shape, lambda i: (0,)),
            pl.BlockSpec((L, lane_block), lanes),
            pl.BlockSpec((n_ops, lane_block), lanes),
        ],
        out_specs=[
            pl.BlockSpec((L, lane_block), lanes),
            pl.BlockSpec((n_ops, lane_block), lanes),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((L, Rp), jnp.float32),
            jax.ShapeDtypeStruct((n_ops, Rp), jnp.int32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(1, lane_block // 32), num_stages=1),
        interpret=interpret,
        name="dynamics_walk",
    )(scal, table, xk, entries)
    return out[:, :R], z[:, :R]


def auto_segments(C: int, T: int) -> int:
    """Segments per channel for the offline walk: enough lanes to fill the
    card (TARGET_LANES) with segments no shorter than MIN_SEGMENT samples."""
    return max(1, min(TARGET_LANES // max(C, 1), T // MIN_SEGMENT))


def _divisor_at_most(T: int, g: int) -> int:
    """Largest divisor of T not above g: segments then tile the signal
    exactly, with no padding inside the timeline."""
    g = max(1, min(g, T))
    while T % g:
        g -= 1
    return g


def walk_offline(params_list, x: jnp.ndarray, entry: jnp.ndarray | None = None,
                 segments: int | None = None, interpret: bool = False):
    """Whole-signal automaton cascade, segment-parallel: ``x`` (C, T) from
    encoded entry states ``entry`` (n_ops, C) (REST when None) ->
    (output (C, T), exit states (n_ops, C), sweeps run).

    The sweep loop runs until the segment entry states reach their fixpoint,
    so output and exit states equal the serial simulation exactly."""
    params_list = list(params_list)
    n_ops = len(params_list)
    C, T = x.shape
    G = _divisor_at_most(T, segments or auto_segments(C, T))
    L = T // G
    if entry is None:
        entry = jnp.zeros((n_ops, C), jnp.int32)
    # (C, G, L) -> time-major (L, G*C): lane r = g*C + c
    xk = jax.lax.reshape(x.reshape(C, G, L), (L, G * C), dimensions=(2, 1, 0))

    def next_entries(z):
        # segment 0 keeps the true entry; segment g takes segment g-1's exit
        z = z.reshape(n_ops, G, C)
        return jnp.concatenate([entry[:, None, :], z[:, :-1, :]],
                               axis=1).reshape(n_ops, G * C)

    sweep = partial(walk, params_list, xk, interpret=interpret)
    e0 = jnp.broadcast_to(entry[:, None, :], (n_ops, G, C)).reshape(
        n_ops, G * C)
    out, z = sweep(e0)
    e1 = next_entries(z)

    def cond(carry):
        e, en, _, _, _ = carry
        return jnp.any(e != en)

    def body(carry):
        _, e, _, _, it = carry
        out, z = sweep(e)
        return e, next_entries(z), out, z, it + 1

    _, _, out, z, sweeps = jax.lax.while_loop(
        cond, body, (e0, e1, out, z, jnp.int32(1)))
    out = jax.lax.reshape(out.reshape(L, G, C), (C, T), dimensions=(2, 1, 0))
    return out, z.reshape(n_ops, G, C)[:, -1, :], sweeps


def walk_effect(effects, interpret: bool = False) -> Effect:
    """ONE Effect running a cascade of dynamics automatons (compressor/gate,
    any order and number, a lone one included) through the walk kernel.
    Offline renders walk the whole signal segment-parallel; a streaming step
    walks one block with one lane per channel. State is the tuple of the
    ops' ops/dynamics.init_state dicts."""
    params = tuple(e.params for e in effects)

    def offline(params, blocks: jnp.ndarray) -> jnp.ndarray:
        # leading axes are channels: (..., nb, B) -> (C, T)
        x = blocks.reshape(-1, blocks.shape[-2] * blocks.shape[-1])
        out, _, _ = walk_offline(params, x, interpret=interpret)
        return out.reshape(blocks.shape)

    def step(params, state, block: jnp.ndarray):
        lead = block.shape[:-1]
        entries = jnp.stack([encode_state(p, st).reshape(-1)
                             for p, st in zip(params, state)])
        out, z = walk(params, block.reshape(-1, block.shape[-1]).T, entries,
                      interpret=interpret)
        new_state = tuple(
            {k: v.reshape(lead) for k, v in decode_state(p, z[j]).items()}
            for j, p in enumerate(params))
        return new_state, out.T.reshape(block.shape)

    def init_state(params, batch_shape: tuple[int, ...] = ()):
        return tuple(dyn.init_state(p, batch_shape) for p in params)

    name = "+".join(e.name for e in effects) + "_walk"
    return Effect(name=name, params=params, init_state=init_state, step=step,
                  offline=offline, time_parallel=False)
