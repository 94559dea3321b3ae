"""Core-layer tests: blocking, wav I/O, generators, utility, metering."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyaudiodsptools_tpu.core import block as blk
from pyaudiodsptools_tpu.core import generators, metering, utility, wavio
from pyaudiodsptools_tpu.core.config import EngineConfig

from ref_loader import ref_config, snr_db


def test_make_combine_roundtrip():
    sig = jnp.arange(1000, dtype=jnp.float32)
    b = blk.make_blocks(sig, 512)
    assert b.shape == (2, 512)
    out = blk.combine_blocks(b, 1000)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(sig))
    # padded tail is zero
    full = np.asarray(blk.combine_blocks(b))
    assert full.shape == (1024,)
    assert np.all(full[1000:] == 0)


def test_legacy_chunk_sizes_quirk():
    # reference: 1000 samples / 512 chunk -> 2 chunks of 500 (Utility.py:23)
    assert blk.legacy_chunk_sizes(1000, 512) == [500, 500]
    assert blk.legacy_chunk_sizes(264600, 4096) == [4096] * 65


def test_config_validation():
    with pytest.raises(ValueError):
        EngineConfig(sample_rate=0)
    cfg = EngineConfig(44100, 512)
    assert abs(cfg.block_duration_ms - 11.61) < 0.01
    assert cfg.ms_to_samples(3.1) == 136  # EffectCompressor.py:29 semantics


def test_wav_16bit_parity_with_reference():
    ref = ref_config()
    golden = ref.MonoWavToNumpyFloat("/root/reference/TestFile16BitMono.wav")
    ours = wavio.mono_wav_to_float("/root/reference/TestFile16BitMono.wav")
    np.testing.assert_array_equal(golden, ours)

    from pyAudioDspTools.Utility import StereoWavToNumpyFloat
    gl, gr = StereoWavToNumpyFloat("/root/reference/TestFile16BitStereo.wav")
    ol, our_r = wavio.stereo_wav_to_float("/root/reference/TestFile16BitStereo.wav")
    np.testing.assert_array_equal(gl, ol)
    np.testing.assert_array_equal(gr, our_r)

    gi = ref.MonoWavToNumpy16BitInt("/root/reference/TestFile16BitMono.wav")
    oi = wavio.mono_wav_to_int16("/root/reference/TestFile16BitMono.wav")
    np.testing.assert_array_equal(gi, oi)


def test_wav_24bit_read(tmp_path):
    """The reference cannot read 24-bit wavs (dead code,
    Utility.py:107-121); we can. The fixture pair is one generated program
    written once as 24-bit and once as 16-bit PCM."""
    import wave

    from pyaudiodsptools_tpu.core import generators

    sig = generators.demo_signal(264600, 44100)
    i24 = np.round(sig.astype(np.float64) * 2 ** 23).astype("<i4")
    p24 = str(tmp_path / "x24.wav")
    with wave.open(p24, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(3)
        f.setframerate(44100)
        f.writeframes(i24.view(np.uint8).reshape(-1, 4)[:, :3].tobytes())
    p16 = str(tmp_path / "x16.wav")
    wavio.write_wav(p16, sig, 44100)

    audio, rate = wavio.read_wav(p24)
    assert rate == 44100
    assert audio.shape == (264600,)
    assert np.abs(audio).max() <= 1.0
    np.testing.assert_allclose(audio, sig, atol=2.0 ** -23)
    # same program as the 16-bit file: waveforms should correlate strongly
    a16 = wavio.mono_wav_to_float(p16)
    corr = np.corrcoef(audio, a16)[0, 1]
    assert corr > 0.99


def test_wav_write_roundtrip(tmp_path):
    sig = (np.sin(np.linspace(0, 100, 44100)) * 0.8).astype(np.float32)
    path = str(tmp_path / "x.wav")
    wavio.write_wav(path, sig, 44100)
    back, rate = wavio.read_wav(path)
    assert rate == 44100
    assert snr_db(sig, back) > 55.0  # int16 quantization


def test_generators_parity():
    ref = ref_config(44100, 512)
    g_sine = ref.CreateSinewave(1000, 4096)
    o_sine = np.asarray(generators.sine(1000, 4096, 44100))
    np.testing.assert_array_equal(g_sine, o_sine)

    g_sq = ref.CreateSquarewave(440, 4096)
    o_sq = np.asarray(generators.square(440, 4096, 44100))
    np.testing.assert_array_equal(g_sq, o_sq)


def test_whitenoise_band_limits():
    key = jax.random.key(0)
    n = 44100
    noise = np.asarray(generators.whitenoise(key, n, 44100))
    spec = np.abs(np.fft.rfft(noise))
    freqs = np.fft.rfftfreq(n, 1 / 44100)
    in_band = spec[(freqs > 100) & (freqs < 15000)].mean()
    out_band = spec[freqs < 10].mean()
    assert in_band > 50 * max(out_band, 1e-12)


def test_utility_parity():
    ref = ref_config(44100, 512)
    rng = np.random.default_rng(0)
    sig = (rng.standard_normal(4096) * 0.4).astype(np.float32)

    assert abs(float(utility.info_dbv(jnp.asarray(sig))) - ref.InfodBV(sig)) < 1e-4
    np.testing.assert_allclose(
        np.asarray(utility.volume_change(jnp.asarray(sig), -6.0)),
        ref.VolumeChange(sig.copy(), -6.0), atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(utility.dbv_to_16bit(jnp.asarray(sig))),
        ref.ConvertdBVTo16Bit(sig.copy()))

    a = (rng.standard_normal(1024) * 0.5).astype(np.float32)
    b = (rng.standard_normal(1024) * 0.5).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(utility.mix_signals(jnp.asarray(a), jnp.asarray(b))),
        ref.MixSignals(a, b), atol=1e-6)


def test_dither_ranges():
    key = jax.random.key(1)
    x16 = (np.random.default_rng(0).integers(-32768, 32767, 4096)
           ).astype(np.int16)
    out8 = np.asarray(utility.dither_16bit_to_8bit(key, jnp.asarray(x16)))
    assert out8.min() >= -127 and out8.max() <= 127
    x32 = (np.random.default_rng(1).integers(-2**31, 2**31 - 1, 4096)
           ).astype(np.int32)
    out16 = np.asarray(utility.dither_32bit_to_16bit(key, jnp.asarray(x32)))
    assert out16.dtype == np.int16


def test_metering():
    sig = jnp.asarray(np.array([0.5, -1.0, 0.25, 0.0], dtype=np.float32))
    m = metering.summary_meters(sig)
    assert float(m["peak"]) == 1.0
    assert float(m["clipped"]) == 1.0
    blocks = sig.reshape(2, 2)
    bm = metering.block_meters(blocks)
    np.testing.assert_allclose(np.asarray(bm["peak"]), [1.0, 0.25])
