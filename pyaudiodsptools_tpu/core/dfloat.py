"""Double-float (f32x2, "double-double" style) compensated arithmetic.

A value is carried as an unevaluated sum ``hi + lo`` of two float32s with
``|lo| <= ulp(hi)/2`` — ~49 bits of effective mantissa, more than float64's
53 minus headroom, all in native f32 ops. Used where a recurrence must
match the reference's float64 loops beyond what plain f32 reaches (the
EQ3Band biquad associative scan, ops/eq3band.py; parity target
/root/reference/pyAudioDspTools/EffectEQ3Band.py:111-113's float64 math).

Algorithms are the classical error-free transformations (Knuth two-sum,
Dekker/Veltkamp split + two-product — no FMA dependence, so they lower to
plain adds/muls on any XLA backend). XLA does not reassociate floating-point
ops by default, so the compensation terms survive compilation.
"""

from __future__ import annotations

import jax.numpy as jnp

# Veltkamp splitter for float32 (24-bit mantissa): 2^12 + 1.
_SPLIT = 4097.0


def two_sum(a, b):
    """Error-free a + b: returns (s, e) with s = fl(a+b), s + e == a + b."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fast_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b|."""
    s = a + b
    return s, b - (s - a)


def split(a):
    """Veltkamp split of f32 a into hi + lo with 12/12 mantissa bits."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b: returns (p, e) with p = fl(a*b), p + e == a * b."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def add(xh, xl, yh, yl):
    """Double-float addition (x + y)."""
    s, e = two_sum(xh, yh)
    return fast_two_sum(s, e + (xl + yl))


def mul(xh, xl, yh, yl):
    """Double-float multiplication (x * y)."""
    p, e = two_prod(xh, yh)
    return fast_two_sum(p, e + (xh * yl + xl * yh))


def from_f64(a) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Split host-side float64 values into an f32 (hi, lo) pair (numpy in,
    jnp out); the pair reproduces the f64 value to ~49 bits."""
    import numpy as np

    a = np.asarray(a, dtype=np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def to_f32(xh, xl):
    """Round a double-float back to a single f32."""
    return (xh + xl).astype(jnp.float32)
