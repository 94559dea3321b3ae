"""Tremolo: sinusoidal LFO amplitude modulation.

Parity target: ``/root/reference/pyAudioDspTools/EffectTremolo.py:19-57``. The
reference precomputes one LFO period (``sr / lfo_hz`` samples, depth-scaled
sine mapped to [1-depth, 1]) and consumes it from a rolling copy, appending
full periods as needed. Because appends always extend the *periodic
continuation*, the consumed gain for absolute phase p is ``lfo[p mod L]`` —
EXCEPT for a reference quirk: when the rolling copy's remaining length hits
exactly the chunk size, the slice ``copy[-0:]`` returns the whole array, so the
phase freezes and that LFO segment repeats for all subsequent chunks. The
``phase``/``avail`` carry replicates this exactly (compat behavior); the
offline path precomputes the per-block phase schedule on host.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.config import EngineConfig
from .base import Effect, pytree_dataclass


@pytree_dataclass(meta_fields=("lfo_length", "block_size"))
class TremoloParams:
    lfo: jnp.ndarray       # one LFO period, float32, (lfo_length,)
    omega: jnp.ndarray     # 2*pi*lfo_hz/sample_rate (f32 scalar)
    depth: jnp.ndarray     # f32 scalar
    lfo_length: int
    block_size: int


def tremolo(cfg: EngineConfig, depth: float = 0.4, lfo_hz: float = 4.5) -> Effect:
    sr = cfg.sample_rate
    # Length via float32 rounding of sr/lfo_hz, as the reference does
    # (EffectTremolo.py:21: arange(float32(sr/hz))).
    length = int(np.arange(np.float32(sr / lfo_hz)).shape[0])
    t = np.arange(length)
    lfo = np.float32(
        (((np.sin(2 * np.pi * lfo_hz * t / sr) / 2) + 0.5) * depth) + (1 - depth)
    )
    params = TremoloParams(lfo=jnp.asarray(lfo),
                           omega=jnp.float32(2 * np.pi * lfo_hz / sr),
                           depth=jnp.float32(depth),
                           lfo_length=length,
                           block_size=cfg.block_size)
    return Effect(name="tremolo", params=params, init_state=init_state,
                  step=step, offline=offline)


def init_state(params: TremoloParams, batch_shape: tuple[int, ...] = ()):
    """LFO position: absolute phase into the periodic stream plus the rolling
    copy's remaining length (which controls the reference's freeze quirk).
    Scalar state — the LFO is shared across channels, as in the reference."""
    return {
        "phase": jnp.zeros((), dtype=jnp.int32),
        "avail": jnp.asarray(params.lfo_length, dtype=jnp.int32),
    }


def _advance(params: TremoloParams, phase, avail, n: int):
    """One chunk's worth of the reference's append/consume logic
    (EffectTremolo.py:42-45)."""
    L = params.lfo_length
    # while len(copy) < n: append a full period
    deficit = jnp.maximum(n - avail, 0)
    appends = (deficit + L - 1) // L
    avail = avail + appends * L
    # Freeze quirk: when avail == n the slice [-0:] keeps the whole copy.
    frozen = avail == n
    new_phase = jnp.where(frozen, phase, (phase + n) % L)
    new_avail = jnp.where(frozen, avail, avail - n)
    return new_phase, new_avail


def _gains(params: TremoloParams, phase, n: int) -> jnp.ndarray:
    idx = (phase + jnp.arange(n, dtype=jnp.int32)) % params.lfo_length
    return params.lfo[idx]


def step(params: TremoloParams, state, block: jnp.ndarray):
    n = block.shape[-1]
    gains = _gains(params, state["phase"], n)
    phase, avail = _advance(params, state["phase"], state["avail"], n)
    out = (block * gains).astype(jnp.float32)
    return {"phase": phase, "avail": avail}, out


def phase_schedule(params: TremoloParams, num_blocks: int, n: int | None = None
                   ) -> np.ndarray:
    """Host-side exact simulation of the per-block phase sequence, including
    the freeze quirk. Cheap (O(num_blocks) scalar ops) and static."""
    n = params.block_size if n is None else n
    L = params.lfo_length
    phase, avail = 0, L
    phases = np.empty(num_blocks, dtype=np.int64)
    for i in range(num_blocks):
        phases[i] = phase
        if avail < n:
            avail += L * (-(-(n - avail) // L))
        if avail == n:
            pass  # frozen: phase and avail unchanged
        else:
            phase = (phase + n) % L
            avail -= n
    return phases


def gain_row(params: TremoloParams, nb: int, n: int) -> jnp.ndarray:
    """The whole render's per-sample gain as one flat (nb*n,) f32 row (the
    offline path)."""
    phases = jnp.asarray(phase_schedule(params, nb, n), dtype=jnp.int32)
    idx = (phases[:, None] + jnp.arange(n, dtype=jnp.int32)[None, :]) % params.lfo_length
    # Arithmetic LFO instead of a table gather: a signal-sized gather costs
    # more than the fused elementwise sin. The reference's table is
    # float32(sin(...)) of the SAME mod-L index (periodicity is only exact when sr/lfo_hz is
    # an integer, hence the explicit mod); computing sin in f32 on device
    # differs from the f64-built table by ulps (>130 dB, bound is 60).
    ph = idx.astype(jnp.float32) * params.omega
    gains = (jnp.sin(ph) * 0.5 + 0.5) * params.depth + (1.0 - params.depth)
    return gains.reshape(-1)


def offline(params: TremoloParams, blocks: jnp.ndarray) -> jnp.ndarray:
    nb, n = blocks.shape[-2], blocks.shape[-1]
    gains = gain_row(params, nb, n).reshape(nb, n)
    return (blocks * gains).astype(jnp.float32)
