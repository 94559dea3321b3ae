"""3-band EQ, biquad (time-domain) form.

Parity target: ``/root/reference/pyAudioDspTools/EffectEQ3Band.py`` — RBJ
Audio-EQ-Cookbook biquads: low shelf (:67-72), peaking mid with Q=2.5
(:75-80), high shelf (:83-88), each applied by a direct-form-I Python sample
loop with cross-chunk state of the last 2 outputs and last 3 inputs (:36-43).

Two reference quirks replicated/handled deliberately (SURVEY.md §7):

* The reference prepends THREE input samples but only TWO output samples
  before indexing from position 2 (:107-116), so every band filters the input
  *delayed by one sample*: ``y[n] = sum_k b_k x[n-1-k] - sum_k a_k y[n-k]``.
  Replicated exactly (it is audible only as 1 sample of latency per band).
* ``Fs`` is hard-coded to 44100.0 (:33); we honor ``cfg.sample_rate``.

Design: the sequential IIR recurrence is reformulated as a blocked
associative scan over affine maps ``s[n] = M s[n-1] + c[n]`` with the 2x2
companion matrix M — log-depth on device instead of a per-sample Python loop
(SURVEY.md §7 hard part #2). The FIR part of each band is a parallel shifted
multiply-add; only the 2-tap feedback goes through the scan. Bands are chained
low -> mid -> high like the reference's documented usage (ModuleTests.py).

The scan runs in DOUBLE-FLOAT (f32x2 compensated, core/dfloat.py): plain-f32
composition reaches only ~62-68 dB vs the reference's float64 loop because
rounding errors are amplified through the feedback poles; carrying every
coefficient, state word, and inter-band intermediate as an (hi, lo) f32 pair
restores >100 dB while staying in native f32 ops (no x64 mode, which
accelerators run far slower than f32 or only emulate).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import dfloat as dfl
from ..core.config import EngineConfig
from .base import Effect, pytree_dataclass
from . import fft_filter


def rbj_lowshelf(fs: float, freq: float, gain_db: float, q: float = 1.0):
    """RBJ low-shelf coefficients (EffectEQ3Band.py:45-51,67-72), float64."""
    a = np.sqrt(10.0 ** (gain_db / 20.0))
    w0 = 2 * np.pi * freq / fs
    alpha = np.sin(w0) / 2 * np.sqrt((a + 1 / a) * (1 / q - 1) + 2)
    cos = np.cos(w0)
    b0 = a * ((a + 1) - (a - 1) * cos + 2 * np.sqrt(a) * alpha)
    b1 = 2 * a * ((a - 1) - (a + 1) * cos)
    b2 = a * ((a + 1) - (a - 1) * cos - 2 * np.sqrt(a) * alpha)
    a0 = (a + 1) + (a - 1) * cos + 2 * np.sqrt(a) * alpha
    a1 = -2 * ((a - 1) + (a + 1) * cos)
    a2 = (a + 1) + (a - 1) * cos - 2 * np.sqrt(a) * alpha
    return np.array([b0, b1, b2, a0, a1, a2])


def rbj_peaking(fs: float, freq: float, gain_db: float, q: float = 2.5):
    """RBJ peaking-EQ coefficients (EffectEQ3Band.py:54-58,75-80), float64."""
    a = np.sqrt(10.0 ** (gain_db / 20.0))
    w0 = 2 * np.pi * freq / fs
    alpha = np.sin(w0) / (2 * q)
    cos = np.cos(w0)
    return np.array([1 + alpha * a, -2 * cos, 1 - alpha * a,
                     1 + alpha / a, -2 * cos, 1 - alpha / a])


def rbj_highshelf(fs: float, freq: float, gain_db: float, q: float = 1.0):
    """RBJ high-shelf coefficients (EffectEQ3Band.py:61-65,83-88), float64."""
    a = np.sqrt(10.0 ** (gain_db / 20.0))
    w0 = 2 * np.pi * freq / fs
    alpha = np.sin(w0) / 2 * np.sqrt((a + 1 / a) * (1 / q - 1) + 2)
    cos = np.cos(w0)
    b0 = a * ((a + 1) + (a - 1) * cos + 2 * np.sqrt(a) * alpha)
    b1 = -2 * a * ((a - 1) + (a + 1) * cos)
    b2 = a * ((a + 1) + (a - 1) * cos - 2 * np.sqrt(a) * alpha)
    a0 = (a + 1) - (a - 1) * cos + 2 * np.sqrt(a) * alpha
    a1 = 2 * ((a - 1) - (a + 1) * cos)
    a2 = (a + 1) - (a - 1) * cos - 2 * np.sqrt(a) * alpha
    return np.array([b0, b1, b2, a0, a1, a2])


@pytree_dataclass(meta_fields=("n_bands", "use_fir", "halo_blocks",
                               "seg_blocks", "block_size"))
class EQ3BandParams:
    # Normalized coefficients per band, (n_bands, 5): b0', b1', b2', a1', a2'.
    # ``coeffs`` is the f32 head; ``coeffs_lo`` the f32 compensation tail of
    # the float64 value (together ~49 mantissa bits, core/dfloat.py).
    coeffs: jnp.ndarray
    coeffs_lo: jnp.ndarray
    # FIR-ized offline path: the cascade's impulse response truncated at
    # -180 dB (None when the cascade did not decay within the cap).
    spectrum_fir: jnp.ndarray | None
    n_bands: int
    use_fir: bool
    halo_blocks: int
    seg_blocks: int
    block_size: int


_FIR_CAP = 1 << 18          # max impulse-response length considered
_FIR_TRUNC = 1e-9           # truncate below this fraction of the peak


def _impulse_response(rows: np.ndarray) -> np.ndarray | None:
    """float64 impulse response of the delayed-input biquad cascade,
    truncated at the -180 dB tail; None if it has not decayed within the cap
    (marginally stable / boosted-pole settings fall back to the exact scan).

    Grows the simulated length adaptively; each band applies the reference's
    1-sample input delay (EffectEQ3Band.py:107-116 insert-3/insert-2 quirk).
    """
    try:
        from scipy.signal import lfilter
    except ImportError:  # pragma: no cover
        lfilter = None

    T = 1 << 13
    while T <= _FIR_CAP:
        h = np.zeros(T)
        h[0] = 1.0
        for b0, b1, b2, a1, a2 in rows:
            x = np.concatenate([[0.0], h[:-1]])  # the 1-sample input delay
            if lfilter is not None:
                h = lfilter([b0, b1, b2], [1.0, a1, a2], x)
            else:  # pragma: no cover - slow pure-python fallback
                y = np.zeros_like(x)
                y1 = y2 = 0.0
                for n in range(len(x)):
                    xv2 = x[n - 2] if n >= 2 else 0.0
                    xv1 = x[n - 1] if n >= 1 else 0.0
                    v = b0 * x[n] + b1 * xv1 + b2 * xv2 - a1 * y1 - a2 * y2
                    y2, y1 = y1, v
                    y[n] = v
                h = y
        peak = np.abs(h).max()
        if peak == 0:
            return None
        if np.abs(h[-(T // 16):]).max() <= _FIR_TRUNC * peak:
            keep = np.nonzero(np.abs(h) > _FIR_TRUNC * peak)[0]
            return h[: int(keep[-1]) + 1]
        T *= 2
    return None


def _build(cfg: EngineConfig, rows: list, name: str) -> Effect:
    rows = np.array(rows)
    h = _impulse_response(rows)
    if h is not None:
        spec, halo, seg = fft_filter.pack_segmented_kernel(h, cfg.block_size)
    chi, clo = dfl.from_f64(rows)
    params = EQ3BandParams(
        coeffs=chi,
        coeffs_lo=clo,
        spectrum_fir=spec if h is not None else None,
        n_bands=len(rows),
        use_fir=h is not None,
        halo_blocks=halo if h is not None else 1,
        seg_blocks=seg if h is not None else 7,
        block_size=cfg.block_size,
    )
    # Decayed cascade: offline = one segmented FFT convolution (parity with
    # the recursion to the -180 dB truncation level, and time-shardable).
    # Undecayed: exact associative-scan path, channel-sharded only.
    off = offline_fir if h is not None else offline
    return Effect(name=name, params=params, init_state=init_state,
                  step=step, offline=off, time_parallel=h is not None)


def eq3band(cfg: EngineConfig, low_shelf_hz: float, low_shelf_db: float,
            mid_hz: float, mid_db: float, high_shelf_hz: float,
            high_shelf_db: float) -> Effect:
    fs = float(cfg.sample_rate)
    rows = []
    for raw in (rbj_lowshelf(fs, low_shelf_hz, low_shelf_db),
                rbj_peaking(fs, mid_hz, mid_db),
                rbj_highshelf(fs, high_shelf_hz, high_shelf_db)):
        b0, b1, b2, a0, a1, a2 = raw
        rows.append([b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0])
    return _build(cfg, rows, "eq3band")


def eq_band(cfg: EngineConfig, kind: str, freq: float, gain_db: float) -> Effect:
    """A single EQ band as its own effect (the reference exposes the bands as
    separate ``applylowband``/``applymidband``/``applyhighband`` methods,
    EffectEQ3Band.py:90,121,152 — this supports that per-band API)."""
    fs = float(cfg.sample_rate)
    raw = {"low": rbj_lowshelf, "mid": rbj_peaking, "high": rbj_highshelf}[kind](
        fs, freq, gain_db)
    b0, b1, b2, a0, a1, a2 = raw
    return _build(cfg, [[b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0]],
                  f"eq_band_{kind}")


_ST_KEYS = ("x1", "x2", "x3", "y1", "y2",
            "x1l", "x2l", "x3l", "y1l", "y2l")


def init_state(params: EQ3BandParams, batch_shape: tuple[int, ...] = ()):
    """Per band: last 3 raw inputs (x1 newest) and last 2 outputs (y1 newest)
    — exactly the reference's PrevOriginalChunkSample / PrevChunkSample
    (EffectEQ3Band.py:36-43). Each word carries an f32x2 compensation tail
    (``*l`` keys) so the cross-block recurrence stays float64-accurate."""
    nb = params.n_bands
    z = jnp.zeros((nb,) + batch_shape, dtype=jnp.float32)
    return {k: z for k in _ST_KEYS}


def _df_mm2(Ah, Al, Bh, Bl):
    """Double-float (..., i, 2) @ (..., 2, j) — written out so every entry is
    one compensated product-sum chain."""
    ph, pl = dfl.mul(Ah[..., :, :, None], Al[..., :, :, None],
                     Bh[..., None, :, :], Bl[..., None, :, :])
    return dfl.add(ph[..., :, 0, :], pl[..., :, 0, :],
                   ph[..., :, 1, :], pl[..., :, 1, :])


def _band(params: EQ3BandParams, band: int, st, xh: jnp.ndarray,
          xl: jnp.ndarray):
    """One biquad band over the last axis of ``(xh, xl)`` via a double-float
    associative scan.

    Recurrence (with the reference's 1-sample input delay):
        y[n] = b0 x[n-1] + b1 x[n-2] + b2 x[n-3] - a1 y[n-1] - a2 y[n-2]
    """
    cf = [(params.coeffs[band, i], params.coeffs_lo[band, i])
          for i in range(5)]
    b0, b1, b2, a1, a2 = cf
    na1 = (-a1[0], -a1[1])
    na2 = (-a2[0], -a2[1])

    def stf(k):
        return st[k][band], st[k + "l"][band]

    def shift(vh, vl, k, fills):
        # v delayed by k samples along the last axis, head filled from state.
        if not k:
            return vh, vl
        hh = jnp.stack([f[0] for f in fills], axis=-1)
        hl = jnp.stack([f[1] for f in fills], axis=-1)
        return (jnp.concatenate([hh, vh[..., :-k]], axis=-1),
                jnp.concatenate([hl, vl[..., :-k]], axis=-1))

    x1, x2, x3 = stf("x1"), stf("x2"), stf("x3")
    y1, y2 = stf("y1"), stf("y2")

    xd1 = shift(xh, xl, 1, [x1])
    xd2 = shift(xh, xl, 2, [x2, x1])
    xd3 = shift(xh, xl, 3, [x3, x2, x1])
    c = dfl.add(*dfl.mul(*b0, *xd1),
                *dfl.add(*dfl.mul(*b1, *xd2), *dfl.mul(*b2, *xd3)))

    # Fold the initial output state into the first two forcing terms:
    # y[0] = c[0] - a1 y[-1] - a2 y[-2]; y[1] = c[1] - a1 y[0] - a2 y[-1].
    t0 = dfl.add(*dfl.mul(*na1, *y1), *dfl.mul(*na2, *y2))
    c00 = dfl.add(c[0][..., 0], c[1][..., 0], *t0)
    ch = c[0].at[..., 0].set(c00[0])
    cl = c[1].at[..., 0].set(c00[1])
    if ch.shape[-1] > 1:
        t1 = dfl.mul(*na2, *y1)
        c01 = dfl.add(ch[..., 1], cl[..., 1], *t1)
        ch = ch.at[..., 1].set(c01[0])
        cl = cl.at[..., 1].set(c01[1])

    # Affine associative scan: s[n] = M s[n-1] + [c[n], 0],
    # M = [[-a1,-a2],[1,0]]. Both M and v ride as (hi, lo) leaf pairs; the
    # time axis stays at -3 so one scan axis serves all four leaves.
    n = ch.shape[-1]
    shape = ch.shape[:-1] + (n, 2, 2)
    mh = jnp.broadcast_to(
        jnp.array([[na1[0], na2[0]], [1.0, 0.0]], dtype=ch.dtype), shape)
    ml = jnp.broadcast_to(
        jnp.array([[na1[1], na2[1]], [0.0, 0.0]], dtype=ch.dtype), shape)
    vh = jnp.stack([ch, jnp.zeros_like(ch)], axis=-1)[..., None]
    vl = jnp.stack([cl, jnp.zeros_like(cl)], axis=-1)[..., None]

    def compose(left, right):
        mlh, mll, vlh, vll = left
        mrh, mrl, vrh, vrl = right
        nmh, nml = _df_mm2(mrh, mrl, mlh, mll)
        wh, wl = _df_mm2(mrh, mrl, vlh, vll)
        nvh, nvl = dfl.add(wh, wl, vrh, vrl)
        return (nmh, nml, nvh, nvl)

    res = jax.lax.associative_scan(compose, (mh, ml, vh, vl), axis=mh.ndim - 3)
    yh, yl = res[2][..., 0, 0], res[3][..., 0, 0]

    new_st = ((xh[..., -1], xl[..., -1]), (xh[..., -2], xl[..., -2]),
              (xh[..., -3], xl[..., -3]), (yh[..., -1], yl[..., -1]),
              (yh[..., -2], yl[..., -2]))
    return new_st, yh, yl


def _apply(params: EQ3BandParams, state, x: jnp.ndarray):
    new_state = {k: [] for k in _ST_KEYS}
    xh, xl = x, jnp.zeros_like(x)
    for band in range(params.n_bands):
        st, xh, xl = _band(params, band, state, xh, xl)
        for k, v in zip(("x1", "x2", "x3", "y1", "y2"), st):
            new_state[k].append(v[0])
            new_state[k + "l"].append(v[1])
    state = {k: jnp.stack(v, axis=0) for k, v in new_state.items()}
    return state, dfl.to_f32(xh, xl)


def step(params: EQ3BandParams, state, block: jnp.ndarray):
    return _apply(params, state, block)


def offline_fir(params: EQ3BandParams, blocks: jnp.ndarray) -> jnp.ndarray:
    """FIR-ized whole-signal path: segmented FFT convolution with the
    truncated cascade impulse response."""
    return fft_filter.segmented_fft_conv(
        params.spectrum_fir, blocks, 0, params.block_size,
        params.halo_blocks, params.seg_blocks)


def offline(params: EQ3BandParams, blocks: jnp.ndarray,
            segment_samples: int = 65536) -> jnp.ndarray:
    """Whole-signal path: associative scan within ~64k-sample segments (keeps
    the O(n) 2x2-matrix temporaries bounded), sequential carry across
    segments via lax.scan."""
    shape = blocks.shape
    nb, B = shape[-2], shape[-1]
    group = max(1, min(nb, segment_samples // B))
    while nb % group:
        group -= 1
    segs = blocks.reshape(shape[:-2] + (nb // group, group * B))
    segs_t = jnp.moveaxis(segs, -2, 0)  # (n_seg, ..., S)
    state = init_state(params, shape[:-2])

    def body(st, seg):
        return _apply(params, st, seg)

    _, out_t = jax.lax.scan(body, state, segs_t)
    return jnp.moveaxis(out_t, 0, -2).reshape(shape)
