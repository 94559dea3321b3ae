"""Parity + unit tests for the overlap-save FFT filters.

Golden model: /root/reference/pyAudioDspTools/EffectFFTFilter.py run live.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyaudiodsptools_tpu.core.config import EngineConfig
from pyaudiodsptools_tpu.core import block as blk
from pyaudiodsptools_tpu.ops import fft_filter

from ref_loader import chunked, ref_config, run_ref_device, snr_db


def _rng_signal(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.3).astype(np.float32)


@pytest.mark.parametrize("block_size", [512, 4096])
@pytest.mark.parametrize("kind,cutoff", [("lowcut", 800.0), ("highcut", 4000.0)])
def test_parity_streaming(block_size, kind, cutoff):
    ref = ref_config(44100, block_size)
    sig = _rng_signal(block_size * 7 + 123)
    chunks = chunked(sig, block_size)

    if kind == "lowcut":
        dev = ref.CreateLowCutFilter(cutoff)
    else:
        dev = ref.CreateHighCutFilter(cutoff)
    golden = run_ref_device(dev, chunks)

    cfg = EngineConfig(sample_rate=44100, block_size=block_size)
    eff = getattr(fft_filter, kind)(cfg, cutoff)
    state = eff.state()
    outs = []
    for c in chunks:
        state, out = eff(state, jnp.asarray(c))
        outs.append(np.asarray(out))
    ours = np.concatenate(outs)

    assert snr_db(golden, ours) > 100.0


def test_offline_matches_streaming():
    cfg = EngineConfig(sample_rate=44100, block_size=512)
    eff = fft_filter.lowcut(cfg, 300.0)
    sig = _rng_signal(512 * 5)
    blocks = blk.make_blocks(jnp.asarray(sig), 512)

    state = eff.state()
    outs = []
    for i in range(blocks.shape[0]):
        state, out = eff(state, blocks[i])
        outs.append(out)
    streamed = jnp.stack(outs)

    batched = eff.offline(eff.params, blocks)
    np.testing.assert_allclose(np.asarray(streamed), np.asarray(batched),
                               rtol=0, atol=1e-6)


def test_offline_batched_channels():
    cfg = EngineConfig(sample_rate=44100, block_size=512)
    eff = fft_filter.highcut(cfg, 6000.0)
    sig = np.stack([_rng_signal(512 * 4, seed=s) for s in range(3)])
    blocks = blk.make_blocks(jnp.asarray(sig), 512)  # (3, 4, 512)
    out = eff.offline(eff.params, blocks)
    assert out.shape == blocks.shape
    # each channel independently equals the single-channel result
    for c in range(3):
        single = eff.offline(eff.params, blocks[c])
        np.testing.assert_array_equal(np.asarray(out[c]), np.asarray(single))


def test_one_block_latency():
    """Impulse at sample 0 must emerge at sample block_size (EffectFFTFilter.py:10)."""
    cfg = EngineConfig(sample_rate=44100, block_size=512)
    eff = fft_filter.highcut(cfg, 8000.0)
    sig = np.zeros(512 * 4, dtype=np.float32)
    sig[0] = 1.0
    blocks = blk.make_blocks(jnp.asarray(sig), 512)
    out = np.asarray(blk.combine_blocks(eff.offline(eff.params, blocks)))
    peak = np.argmax(np.abs(out))
    assert peak == 512


# ---------------------------------------------------------------------------
# plan_segments geometry (ops/fft_filter.plan_segments): one plan on every
# backend, so the exact (halo, seg) it picks is pinned here.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_size,kernel_len,want", [
    (4096, 2047, (1, 7)),
    (1024, 511, (1, 7)),
    (512, 255, (1, 7)),
    (512, 5 * 512 + 1, (5, 27)),   # 4x-halo floor grows the window
])
def test_plan_segments_cpu_geometry(block_size, kernel_len, want):
    from pyaudiodsptools_tpu.ops.fft_filter import plan_segments

    assert plan_segments(kernel_len, block_size) == want


def test_plan_segments_non_pow2_block_stays_on_fft_path(monkeypatch):
    """A non-pow2 planning unit keeps the default 8-block window, whatever
    the backend (the plan no longer depends on it)."""
    import jax as _jax

    from pyaudiodsptools_tpu.ops.fft_filter import plan_segments

    monkeypatch.setattr(_jax, "default_backend", lambda: "gpu")
    assert plan_segments(255, 500) == (1, 7)


def test_fir_plans_offline_in_512_units():
    """Big pow2 engine blocks plan the OFFLINE segmentation in 512-sample
    units so the halo hugs the stripped kernel (streaming stays on engine
    blocks): a B=4096 chain-like cascade kernel (6143 taps after a 3073-tap
    zero lead) gets halo 12x512 = 6144 instead of 2x4096 = 8192."""
    from pyaudiodsptools_tpu.ops import fft_filter as ff

    eff = ff.fir(np.concatenate([np.zeros(3073), np.random.default_rng(0)
                                 .standard_normal(6143)]), 4096)
    p = eff.params
    assert p.seg_unit == 512
    assert p.lead == 3073
    assert (p.halo, p.seg) == (12, 52)       # n = 64*512 = 32768
    assert p.halo * 512 >= 6143 - 1          # the halo covers the kernel
    # engine-block streaming window unchanged
    assert p.block_size == 4096


def test_fir_single_lowcut_unit_geometry():
    from pyaudiodsptools_tpu import EngineConfig, ops

    p = ops.lowcut(EngineConfig(44100, 4096), 800.0).params
    # stripped kernel 2047 taps: halo 4 units, 4x floor -> n = 16*512
    assert p.seg_unit == 512 and (p.halo, p.seg) == (4, 12)
