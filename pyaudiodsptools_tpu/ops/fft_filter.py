"""Windowed-sinc FFT filters (high-cut / low-cut) via overlap-save.

Behavioral parity target: ``/root/reference/pyAudioDspTools/EffectFFTFilter.py``
(HighCut :5-75, LowCut :78-151): a length ``block_size//2 - 1`` Blackman-windowed
sinc FIR, zero-padded to ``3*block_size``, applied by overlap-save fast
convolution over a 3-block sliding window, introducing exactly one block of
latency.

The device's *effective impulse response* (windowed sinc at its one-block
latency shift) is built once on host in float64 and executed by the generic
``fir`` machinery below with ``jnp.fft`` (cuFFT on the GPU): streaming keeps
the minimal wrap-free window of history blocks + the current block; offline
runs the segmented overlap-save convolution with the exact-zero latency prefix
stripped and re-applied as a free output delay. One code path serves the named
filters, fused LTI cascades, reverbs, and FIR-ized IIR responses alike.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import EngineConfig
from .base import Effect, pytree_dataclass


def sinc_kernel(cutoff_hz: float, sample_rate: float, filter_length: int,
                window: str = "blackman", invert: bool = False) -> np.ndarray:
    """Host-side windowed-sinc FIR construction, float64.

    Mirrors the reference's construction order exactly (EffectFFTFilter.py:27-37,
    spectral inversion :112-113): sinc, window, unity-gain normalize, optional
    spectral inversion (lowpass -> highpass).
    """
    n = np.arange(filter_length)
    h = np.sinc(2 * cutoff_hz / sample_rate * (n - (filter_length - 1) / 2))
    if window == "blackman":
        h *= np.blackman(filter_length)
    elif window == "kaiser6":
        h *= np.kaiser(filter_length, 6.0)
    else:  # pragma: no cover
        raise ValueError(f"unknown window: {window}")
    h /= np.sum(h)
    if invert:
        h = -h
        h[(filter_length - 1) // 2] += 1
    return h


# Segmented offline convolution: G output blocks per (G+1)-block FFT window
# (1-block left halo covers any kernel < B). (G+1)*B is a power of two when
# B is, keeping XLA's FFT on its fast path.
SEGMENT_BLOCKS = 7


def pack_spectrum(spec: np.ndarray) -> jnp.ndarray:
    """Complex spectrum -> stacked (2, n) float32 [real; imag].

    Spectra travel to the device as float pairs and become complex on device
    (``unpack_spectrum``): float pairs cost the same bytes as complex64 and
    keep params pytrees real-valued.
    """
    return jnp.asarray(
        np.stack([spec.real, spec.imag]).astype(np.float32))


def unpack_spectrum(packed: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.complex(packed[0], packed[1])


def _make(cfg: EngineConfig, cutoff_hz: float, invert: bool, name: str) -> Effect:
    B = cfg.block_size
    fl = (B // 2) - 1
    kernel = sinc_kernel(cutoff_hz, cfg.sample_rate, fl, "blackman", invert)
    # Effective impulse response incl. the 1-block latency: y = conv(x, e).
    # The output slice [B + fl//2 : 3B - (B - fl//2)] of the reference's
    # wrap-free 3B overlap-save (EffectFFTFilter.py:24-25,73) IS
    # y[m] = conv(x, kernel)[m - (B - fl//2)], so executing the shifted
    # kernel as a causal FIR reproduces it exactly (zero history = zero
    # initial state on both sides).
    eff_kernel = np.concatenate([np.zeros(B - fl // 2), kernel])
    return fir(eff_kernel, B, name=name)


def highcut(cfg: EngineConfig, cutoff_hz: float = 8000.0) -> Effect:
    """Lowpass ("high cut") filter — CreateHighCutFilter parity."""
    return _make(cfg, cutoff_hz, invert=False, name="highcut")


def lowcut(cfg: EngineConfig, cutoff_hz: float = 160.0) -> Effect:
    """Highpass ("low cut") filter — CreateLowCutFilter parity."""
    return _make(cfg, cutoff_hz, invert=True, name="lowcut")


def batched_rfft_filter(window: jnp.ndarray, spectrum: jnp.ndarray,
                        n: int) -> jnp.ndarray:
    """rfft -> spectrum multiply -> irfft over the last axis, with leading axes
    collapsed to one batch dim. The collapse keeps XLA's FFT on a dim0-major
    layout (XLA:CPU's fft thunk rejects the transposed layouts GSPMD sometimes
    picks for >2D sharded operands) and changes nothing numerically.

    ``spectrum`` is the packed (2, n//2+1) real/imag form (pack_spectrum)."""
    shape = window.shape
    flat = window.reshape(-1, shape[-1])
    h = unpack_spectrum(spectrum)
    out = jnp.fft.irfft(jnp.fft.rfft(flat, axis=-1) * h, n=n, axis=-1)
    return out.reshape(shape[:-1] + (n,))


def plan_segments(kernel_len: int, block_size: int) -> tuple[int, int]:
    """(halo_blocks, seg_blocks) for a kernel of this length: halo covers the
    kernel, window = halo + seg is a power-of-two block count >= 8 and
    >= 4x the halo. The 4x floor keeps the wasted window fraction <= 1/4:
    flops grow only logarithmically with the window, while the bytes of the
    overlapping windows scale with total/(total-halo)."""
    halo = max(1, -(-(kernel_len - 1) // block_size))
    total = 8
    while total < 4 * halo:
        total *= 2
    return halo, total - halo


def pack_segmented_kernel(kernel: np.ndarray, block_size: int
                          ) -> tuple[jnp.ndarray, int, int]:
    """Kernel -> (packed segment spectrum, halo_blocks, seg_blocks)."""
    halo, seg = plan_segments(len(kernel), block_size)
    seg_len = (halo + seg) * block_size
    spec = np.fft.rfft(np.concatenate([kernel,
                                       np.zeros(seg_len - len(kernel))]))
    return pack_spectrum(spec), halo, seg


def segmented_fft_conv(spectrum_seg: jnp.ndarray, blocks: jnp.ndarray,
                       shift: int, block_size: int, halo_blocks: int = 1,
                       seg_blocks: int = SEGMENT_BLOCKS) -> jnp.ndarray:
    """Linear convolution + output delay via large-segment overlap-save.

    The reference's per-block scheme FFTs every block three times (3B window
    per block). Its output slice is wrap-free, so ``out[m] = y[m - shift]``
    with ``y = conv(x, h)`` — any linear-convolution partitioning matches
    bit-for-float. Here: ``seg_blocks`` output blocks per
    ``(halo_blocks + seg_blocks) * B``-point FFT window with a left halo
    covering the kernel; far fewer FFT FLOPs and no 3x window
    materialization. Also serves long kernels (reverb tap trains, FIR-ized
    IIR responses) with proportionally larger windows.

    ``block_size`` here is the PLANNING UNIT of the segmentation — it need
    not equal the engine block size of ``blocks``'s last axis (fir() plans
    big-block configs in 512-sample units so the halo hugs the kernel
    instead of rounding up to a whole engine block).
    """
    B = block_size
    G = seg_blocks
    H = halo_blocks
    lead = blocks.shape[:-2]
    out_shape = blocks.shape
    x = blocks.reshape(lead + (-1,))
    T = x.shape[-1]
    seg_len = G * B
    n_seg = -(-T // seg_len)
    # Left padding = halo + the output delay: gathering every window `shift`
    # samples earlier makes its wrap-free region land exactly on
    # y[m] = conv[m - shift], so no post-conv shift pass is needed.
    x = jnp.pad(x, [(0, 0)] * len(lead)
                + [(H * B + shift, n_seg * seg_len - T)])
    starts = [s * seg_len for s in range(n_seg)]
    windows = jnp.stack(
        [x[..., st : st + (G + H) * B] for st in starts], axis=-2
    )  # (..., n_seg, (G+H)B)
    conv = batched_rfft_filter(windows, spectrum_seg, (G + H) * B)
    y = conv[..., H * B :].reshape(lead + (n_seg * seg_len,))[..., :T]
    return y.reshape(out_shape).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Generic FIR effect from an arbitrary kernel — the execution form of the
# named filters above, fused LTI cascades, reverb tap trains, and FIR-ized
# IIR responses.
# ---------------------------------------------------------------------------


@pytree_dataclass(meta_fields=("block_size", "halo", "seg", "halo_stream",
                               "lead", "seg_unit"))
class FIRParams:
    spectrum: jnp.ndarray      # (2, (halo_stream+1)B//2+1) — streaming window
    spectrum_seg: jnp.ndarray  # (2, (halo+seg)*seg_unit//2 + 1) — offline
    block_size: int            # ENGINE block size (streaming window unit)
    halo: int                  # offline segment halo, in seg_unit units
    seg: int                   # output units per offline FFT window
    halo_stream: int           # streaming history blocks (pow2 window - 1)
    lead: int                  # stripped zero prefix, re-applied as delay
    seg_unit: int = 0          # offline planning unit (<= block_size); big
                               # engine blocks plan at 512 so the halo hugs
                               # the kernel (0 = block_size, legacy pytrees)


def fir(kernel: np.ndarray, block_size: int, name: str = "fir") -> Effect:
    """An Effect computing ``y = conv(x, kernel)`` (causal, zero-latency
    beyond what the kernel itself encodes). Streaming keeps
    ``ceil((len(kernel)-1)/B)`` history blocks; offline uses the segmented
    overlap-save path. This is the execution form of a fused LTI cascade.

    Fused cascades carry a long EXACT-ZERO prefix (each member's latency
    shift): the offline path strips it and re-applies it as a free output
    delay, shrinking the convolution halo (and its FFT flops) by the
    prefix length."""
    B = block_size
    kernel = np.asarray(kernel, dtype=np.float64)
    nz = np.flatnonzero(kernel)
    lead = int(nz[0]) if nz.size else 0
    # Offline segmentation plans in 512-sample units for big pow2 blocks:
    # the halo then hugs the stripped kernel instead of rounding up to a
    # whole engine block (B=4096, a stripped kernel of 6.1k taps: halo
    # 12x512 = 6144 instead of 2x4096 = 8192 samples).
    # Streaming is untouched (engine-block windows).
    u = 512 if (B > 512 and B % 512 == 0) else B
    spec_seg, halo, seg = pack_segmented_kernel(
        kernel[lead:] if nz.size else kernel[:1], u)
    # Streaming keeps the FULL kernel (leading zeros included — streaming has
    # no cheap output-shift) in the MINIMAL window: per-step cost is
    # latency/bandwidth-bound, so the smallest wrap-free window wins. The
    # block count is rounded up to the next 7-smooth integer so the window
    # stays on the FFT's mixed-radix fast path (radix 2/3/5/7; no
    # Bluestein).
    halo_full = max(1, -(-(len(kernel) - 1) // B))
    w = halo_full + 1
    while _largest_prime_factor(w) > 7:
        w += 1
    halo_stream = w - 1
    stream_len = (halo_stream + 1) * B
    spec_stream = np.fft.rfft(
        np.concatenate([kernel, np.zeros(stream_len - len(kernel))]))
    params = FIRParams(
        spectrum=pack_spectrum(spec_stream),
        spectrum_seg=spec_seg,
        block_size=B, halo=halo, seg=seg, halo_stream=halo_stream,
        lead=lead,
        seg_unit=u,
    )
    return Effect(name=name, params=params, init_state=fir_init_state,
                  step=fir_step, offline=fir_offline,
                  lti_kernel=np.asarray(kernel, dtype=np.float64))


def _largest_prime_factor(n: int) -> int:
    f = 2
    last = 1
    while f * f <= n:
        while n % f == 0:
            last = f
            n //= f
        f += 1
    return max(last, n) if n > 1 else last


def fir_init_state(params: FIRParams, batch_shape: tuple[int, ...] = ()):
    return {"hist": jnp.zeros(
        batch_shape + (params.halo_stream, params.block_size),
        dtype=jnp.float32)}


def fir_step(params: FIRParams, state, block: jnp.ndarray):
    B = params.block_size
    h = params.halo_stream
    window = jnp.concatenate(
        [state["hist"].reshape(block.shape[:-1] + (h * B,)), block], axis=-1)
    out = batched_rfft_filter(window, params.spectrum, (h + 1) * B)
    # wrap-free region: kernel length <= halo_stream*B + 1, so the final
    # block is the exact linear convolution.
    out = out[..., h * B :].astype(jnp.float32)
    hist = jnp.concatenate(
        [state["hist"][..., 1:, :], block[..., None, :]], axis=-2)
    return {"hist": hist}, out


def fir_offline(params: FIRParams, blocks: jnp.ndarray) -> jnp.ndarray:
    return segmented_fft_conv(params.spectrum_seg, blocks, params.lead,
                              params.seg_unit or params.block_size,
                              params.halo, params.seg)


def fuse_lti(effects, name: str = "fir_cascade") -> Effect:
    """Fuse consecutive LTI effects into one FIR: the cascade's impulse
    response is the convolution of the members' effective kernels (built in
    float64 on host)."""
    from functools import reduce

    kernels = [np.asarray(e.lti_kernel, dtype=np.float64) for e in effects]
    kernel = reduce(np.convolve, kernels)
    B = getattr(effects[0].params, "block_size")
    return fir(kernel, B, name=name + ":" + "+".join(e.name for e in effects))
