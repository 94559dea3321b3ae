"""Test-signal generators.

Parity with ``/root/reference/pyAudioDspTools/Generators.py`` (sine :5-27,
square :30-54, band-limited white noise :57-92), with one deliberate change:
the reference's noise uses unseeded ``numpy.random`` (Generators.py:84); ours
takes an explicit ``jax.random`` key for reproducibility (SURVEY.md §7 quirks).

All generators take the sample rate explicitly instead of reading a global
config at call time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def sine(frequency: float, n_samples: int, sample_rate: int) -> jnp.ndarray:
    """Sine wave, float32, amplitude 1.0 (Generators.py:5-27 parity)."""
    # The reference computes sin in float64 then casts to float32; match that
    # on host so generated fixtures are bit-identical.
    t = np.arange(n_samples)
    return jnp.asarray(
        np.sin(2 * np.pi * frequency * t / sample_rate).astype(np.float32)
    )


def square(frequency: float, n_samples: int, sample_rate: int) -> jnp.ndarray:
    """Square wave as sign-of-sine (Generators.py:30-54 parity: strictly
    positive sine -> 1.0, else -1.0)."""
    s = np.sin(2 * np.pi * frequency * np.arange(n_samples) / sample_rate)
    return jnp.asarray(np.where(s > 0, 1.0, -1.0).astype(np.float32))


def whitenoise(key: jax.Array, n_samples: int, sample_rate: int,
               low_hz: float = 20.0, high_hz: float = 20000.0) -> jnp.ndarray:
    """Band-limited noise via random spectral phases (Generators.py:57-92).

    Same construction as the reference's ``fftnoise``: unit magnitude in
    [low_hz, high_hz], random phases on the positive frequencies, conjugate
    symmetry, ifft, x5 amplitude — but driven by an explicit PRNG key.
    """
    freqs = jnp.abs(jnp.fft.fftfreq(n_samples, 1.0 / sample_rate))
    f = jnp.where((freqs >= low_hz) & (freqs <= high_hz), 1.0, 0.0)
    n_pos = (n_samples - 1) // 2
    phases = jax.random.uniform(key, (n_pos,), minval=0.0, maxval=2 * jnp.pi)
    phasor = jnp.cos(phases) + 1j * jnp.sin(phases)
    spec = f.astype(jnp.complex64)
    spec = spec.at[1 : n_pos + 1].multiply(phasor)
    spec = spec.at[-1 : -1 - n_pos : -1].set(jnp.conj(spec[1 : n_pos + 1]))
    return (jnp.fft.ifft(spec).real * 5.0).astype(jnp.float32)


def demo_signal(n_samples: int, sample_rate: int, channels: int = 1,
                seed: int = 0) -> np.ndarray:
    """A deterministic test program standing in for the reference's bundled
    TestFile wavs: per channel, a 0.4-amplitude sine (440 Hz times the
    channel number) over band-limited noise. Returns float32 numpy,
    ``(n,)`` for one channel, else ``(channels, n)``."""
    key = jax.random.key(seed)
    rows = [0.4 * np.asarray(sine(440.0 * (c + 1), n_samples, sample_rate))
            + np.asarray(whitenoise(jax.random.fold_in(key, c), n_samples,
                                    sample_rate))
            for c in range(channels)]
    out = np.stack(rows).astype(np.float32)
    return out[0] if channels == 1 else out
