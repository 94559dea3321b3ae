"""3-band EQ, FFT form (Kaiser-windowed shelving filters via overlap-save).

Behavioral parity target: ``/root/reference/pyAudioDspTools/EffectEQ3BandFFT.py``:
three windowed-sinc filters built at init with Kaiser(beta=6) windows —
high shelf = spectrally-inverted lowcut at ``f - f/4`` (:72-90), low shelf =
highcut at ``f + f/4`` (:95-107), mid = lowpass(f+f/4) x highpass(f-f/4)
spectral product (:112-143, combined at :188) — then per block: one shared
forward FFT of the 3-block window, three band multiplies, the shelf-gain trick
``band*g - band = band*(g-1)`` (:195,200,205), mixed with the 1-block-delayed
dry middle chunk (:209). Latency: exactly one block.

Design: the three band responses collapse at build time into ONE weighted
impulse response ``(g_hi-1)*h_hi + (g_lo-1)*h_lo + (g_mid-1)*h_mid``, and the
1-block-delayed dry path is a unit tap at index ``block_size`` — so the whole
EQ is a single FIR executed by the generic ``fft_filter.fir`` machinery
(minimal wrap-free streaming windows; stripped-lead segmented convolution
offline). Per-block cost equals a single FFT filter.
"""

from __future__ import annotations

import numpy as np

from ..core.config import EngineConfig
from .base import Effect
from .fft_filter import fir, sinc_kernel


def eq3band_fft(cfg: EngineConfig, lowshelf_hz: float, lowshelf_db: float,
                mid_hz: float, mid_db: float, highshelf_hz: float,
                highshelf_db: float) -> Effect:
    B = cfg.block_size
    fs = cfg.sample_rate
    fl = (B // 2) - 1

    # Band kernels, built exactly as the reference does (float64 on host).
    h_highshelf = sinc_kernel(highshelf_hz - highshelf_hz / 4, fs, fl,
                              "kaiser6", invert=True)
    h_lowshelf = sinc_kernel(lowshelf_hz + lowshelf_hz / 4, fs, fl, "kaiser6")
    h_mid_lp = sinc_kernel(mid_hz + mid_hz / 4, fs, fl, "kaiser6")
    h_mid_hp = sinc_kernel(mid_hz - mid_hz / 4, fs, fl, "kaiser6", invert=True)
    # Mid band is the spectral product of its low/high pass
    # (EffectEQ3BandFFT.py:188) — a linear convolution in time (support sums
    # to 2fl-1 < B, wrap-free in the reference's 3B transform).
    k_mid = np.convolve(h_mid_lp, h_mid_hp)

    def g(db: float) -> float:
        return 10.0 ** (db / 20.0) - 1.0

    k_combined = (g(highshelf_db) * np.concatenate([h_highshelf,
                                                    np.zeros(fl - 1)])
                  + g(lowshelf_db) * np.concatenate([h_lowshelf,
                                                     np.zeros(fl - 1)])
                  + g(mid_db) * k_mid)

    # Effective impulse response: wet kernel at its latency shift plus the
    # 1-block-delayed dry path (unit tap at index B, EffectEQ3BandFFT.py:209).
    shift = B - fl // 2
    eff_kernel = np.zeros(max(shift + len(k_combined), B + 1))
    eff_kernel[shift : shift + len(k_combined)] += k_combined
    eff_kernel[B] += 1.0
    return fir(eff_kernel, B, name="eq3band_fft")
