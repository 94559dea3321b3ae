"""Stateless waveshapers: Saturator, SoftClipper, HardDistortion, BitCrusher.

Parity targets:
* Saturator — ``/root/reference/pyAudioDspTools/EffectSaturator.py:19-49``:
  fold to magnitude, soft-knee rational shaping above ``10^(thr/20)`` with
  exponent 2 ('soft') or 1 ('hard'), ceiling replace >1.0 with ``(coeff+1)/2``,
  restore sign, makeup gain.
* SoftClipper — ``EffectSoftClipper.py:18-45``: ``-( |x|-1 )^drive + 1`` on
  magnitudes, sign restored, ``drive = param + 1``.
* HardDistortion — ``EffectHardDistortion.py:14-41``: linear below 0.8, then
  sinusoidal compression toward 1.0.
* BitCrusher — ``_EffectBitCrusher.py`` (unexported WIP in the reference,
  shipped first-class here per SURVEY.md §7): int16 quantize, floor-div 512,
  /64 — a ~6-bit crush including the reference's characteristic rescale.

All are pure elementwise maps: state-free, shape-polymorphic, fused by XLA
into whatever surrounds them. ``step`` and ``offline`` share one kernel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.config import EngineConfig
from .base import Effect, pytree_dataclass


def _stateless(name: str, params, fn) -> Effect:
    def init_state(params, batch_shape=()):
        return ()

    def step(params, state, block):
        return state, fn(params, block)

    def offline(params, blocks):
        return fn(params, blocks)

    return Effect(name=name, params=params, init_state=init_state, step=step,
                  offline=offline)


# --------------------------------------------------------------------------
# Saturator


@pytree_dataclass(meta_fields=("mode",))
class SaturatorParams:
    coeff: jnp.ndarray       # 10^(threshold_db/20)
    makeup: jnp.ndarray      # 10^(makeup_db/20)
    mode: int                # soft=2, hard=1 (EffectSaturator.py:22-25)


def saturator(cfg: EngineConfig, threshold_db: float = -20.0,
              makeup_gain_db: float = 2.0, mode: str = "hard") -> Effect:
    params = SaturatorParams(
        coeff=jnp.float32(10.0 ** (threshold_db / 20.0)),
        makeup=jnp.float32(10.0 ** (makeup_gain_db / 20.0)),
        mode={"soft": 2, "hard": 1}[mode],
    )
    return _stateless("saturator", params, _saturate)


def _saturate(p: SaturatorParams, x: jnp.ndarray) -> jnp.ndarray:
    neg = x < 0
    a = jnp.abs(x)
    over = a - p.coeff
    # Rational soft knee above threshold (EffectSaturator.py:45).
    shaped = p.coeff + over / (1.0 + (over / (1.0 - p.coeff)) ** p.mode)
    a = jnp.where(a > p.coeff, shaped, a)
    a = jnp.where(a > 1.0, (p.coeff + 1.0) / 2.0, a)
    return (p.makeup * jnp.where(neg, -a, a)).astype(x.dtype)


# --------------------------------------------------------------------------
# SoftClipper


@pytree_dataclass
class SoftClipperParams:
    drive: jnp.ndarray  # user drive + 1 (EffectSoftClipper.py:20)


def softclipper(cfg: EngineConfig, drive: float = 0.44) -> Effect:
    return _stateless("softclipper", SoftClipperParams(drive=jnp.float32(drive + 1.0)),
                      _softclip)


def _softclip(p: SoftClipperParams, x: jnp.ndarray) -> jnp.ndarray:
    neg = x < 0
    a = jnp.clip(jnp.abs(x), -1.0, 1.0)
    a = -1.0 * jnp.abs(a - 1.0) ** p.drive + 1.0
    return jnp.where(neg, -a, a).astype(x.dtype)


# --------------------------------------------------------------------------
# HardDistortion


@pytree_dataclass
class HardDistortionParams:
    pass


def harddistortion(cfg: EngineConfig) -> Effect:
    return _stateless("harddistortion", HardDistortionParams(), _harddist)


def _harddist(p: HardDistortionParams, x: jnp.ndarray) -> jnp.ndarray:
    hard_limit, linear_limit = 1.0, 0.8
    sign = jnp.where(x >= 0, 1.0, -1.0)
    amplitude = jnp.abs(x)
    # Above the linear region the reference substitutes the *signed* hard
    # limit before the sin shaping (EffectHardDistortion.py:36) — replicated.
    amplitude = jnp.where(amplitude <= linear_limit, amplitude, hard_limit * sign)
    scale = hard_limit - linear_limit
    compression = scale * jnp.sin((amplitude - linear_limit).astype(jnp.float32) / scale)
    return ((linear_limit + compression) * sign).astype(jnp.float32)


# --------------------------------------------------------------------------
# BitCrusher


@pytree_dataclass
class BitCrusherParams:
    pass


def bitcrusher(cfg: EngineConfig) -> Effect:
    return _stateless("bitcrusher", BitCrusherParams(), _bitcrush)


def _bitcrush(p: BitCrusherParams, x: jnp.ndarray) -> jnp.ndarray:
    # int32 intermediate so out-of-range samples wrap like numpy's C cast
    # (XLA float->int16 would saturate instead).
    q = (x * 32767.0).astype(jnp.int32).astype(jnp.int16)
    q = jnp.floor_divide(q, np.int16(512))
    return (q / 64.0).astype(jnp.float32)
