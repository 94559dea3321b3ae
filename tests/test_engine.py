"""Engine-level tests: chains, the Example1 golden anchor, streaming driver,
and the compat drop-in API."""

import numpy as np
import jax.numpy as jnp
import pytest

from pyaudiodsptools_tpu import Chain, EngineConfig, StreamProcessor, ops, render
from pyaudiodsptools_tpu.core import block as blk
from pyaudiodsptools_tpu.core import wavio

from ref_loader import chunked, ref_config, snr_db

MONO_WAV = "/root/reference/TestFile16BitMono.wav"  # the reference's fixture


def _chain8(cfg):
    """The 8-effect serial chain of BASELINE.json config 4."""
    return Chain([
        ops.lowcut(cfg, 120.0),
        ops.highcut(cfg, 12000.0),
        ops.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5),
        ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1),
        ops.gate(cfg, -45.0, 0.1, 3.1, 200.1),
        ops.delay(cfg, 150.0, 2),
        ops.tremolo(cfg, 0.3, 5.0),
        ops.softclipper(cfg, 0.44),
    ])


def test_example1_golden_anchor():
    """Example1.py parity: LowCut(800) @44100/4096 on TestFile16BitMono.wav.

    Golden anchor measured from the reference (SURVEY.md §6): output length
    266,240, RMS 0.0172392.
    """
    ref = ref_config(44100, 4096)  # skips when the reference is absent
    cfg = EngineConfig(sample_rate=44100, block_size=4096)
    audio = wavio.mono_wav_to_float(MONO_WAV)
    chain = Chain([ops.lowcut(cfg, 800)])
    out = np.asarray(render(chain, audio, cfg))
    assert out.shape == (266240,)
    assert abs(float(np.sqrt(np.mean(out.astype(np.float64) ** 2))) - 0.0172392) < 1e-5

    # and against the live reference, sample by sample
    dev = ref.CreateLowCutFilter(800)
    golden = np.concatenate(
        [np.asarray(dev.apply(c)) for c in ref.MakeChunks(audio.copy())])
    assert snr_db(golden, out) > 100.0


def test_chain8_vs_reference():
    """Full 8-effect chain parity, streaming and offline, vs the reference's
    chunk-major device loop."""
    cfg = EngineConfig(sample_rate=44100, block_size=512)
    ref = ref_config(44100, 512)

    rng = np.random.default_rng(0)
    sig = np.clip(rng.standard_normal(512 * 30) * 0.3, -0.99, 0.99).astype(np.float32)

    devices = [
        ref.CreateLowCutFilter(120.0),
        ref.CreateHighCutFilter(12000.0),
        ref.CreateEQ3BandFFT(250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5),
        ref.CreateCompressor(-18.0, 0.6, 3.1, 30.1),
        ref.CreateGate(-45.0, 0.1, 3.1, 200.1),
        ref.CreateDelay(150, 2),
        ref.CreateTremolo(0.3, 5.0),
        ref.CreateSoftClipper(0.44),
    ]
    golden_chunks = []
    for c in chunked(sig, 512):
        c = c.copy()
        for d in devices:
            c = d.apply(c)
        golden_chunks.append(np.asarray(c))
    golden = np.concatenate(golden_chunks)

    chain = _chain8(cfg)
    offline = np.asarray(render(chain, sig, cfg))
    assert snr_db(golden, offline) > 60.0

    state = chain.init_state()
    outs = []
    for c in chunked(sig, 512):
        state, out = chain.step(state, jnp.asarray(c))
        outs.append(np.asarray(out))
    streamed = np.concatenate(outs)
    assert snr_db(golden, streamed) > 60.0
    assert snr_db(streamed, offline) > 80.0


def test_chain8_batched_channels():
    """Channel batching: a (C, n) render equals per-channel renders."""
    cfg = EngineConfig(sample_rate=44100, block_size=512)
    chain = _chain8(cfg)
    rng = np.random.default_rng(1)
    sig = np.clip(rng.standard_normal((4, 512 * 10)) * 0.3, -0.99, 0.99
                  ).astype(np.float32)
    out = np.asarray(render(chain, sig, cfg))
    for c in range(4):
        single = np.asarray(render(chain, sig[c], cfg))
        assert snr_db(single, out[c]) > 100.0 or np.array_equal(single, out[c])


def test_stream_processor_checkpoint(tmp_path):
    cfg = EngineConfig(sample_rate=44100, block_size=512)
    chain = _chain8(cfg)
    rng = np.random.default_rng(2)
    blocks = [rng.standard_normal(512).astype(np.float32) * 0.3 for _ in range(8)]

    sp = StreamProcessor(chain, cfg)
    sp.warmup()
    out_full = [sp.process(b) for b in blocks]

    # process half, checkpoint, resume in a fresh processor
    sp2 = StreamProcessor(chain, cfg)
    for b in blocks[:4]:
        sp2.process(b)
    ckpt = str(tmp_path / "state.npz")
    sp2.save_state(ckpt)
    sp3 = StreamProcessor(chain, cfg)
    sp3.load_state(ckpt)
    out_resumed = [sp3.process(b) for b in blocks[4:]]

    for a, b in zip(out_full[4:], out_resumed):
        np.testing.assert_array_equal(a, b)


def test_compat_drop_in():
    """The compat namespace runs the reference's documented usage unchanged."""
    import pyaudiodsptools_tpu.compat as pat

    pat.config.initialize(44100, 512)
    ref = ref_config(44100, 512)

    sig = pat.CreateSinewave(1000, 512 * 8) * 0.5
    chunks = pat.MakeChunks(sig.copy())

    ours_dev = pat.CreateLowCutFilter(300)
    ref_dev = ref.CreateLowCutFilter(300)
    ours, golden = [], []
    for c in chunks:
        ours.append(ours_dev.apply(c))
        golden.append(ref_dev.apply(c))
    assert snr_db(np.concatenate(golden), np.concatenate(ours)) > 100.0

    # tremolo reset
    trem = pat.CreateTremolo(0.4, 4.5)
    a = trem.apply(chunks[0])
    trem.reset()
    b = trem.apply(chunks[0])
    np.testing.assert_array_equal(a, b)

    # EQ3Band per-band API
    eq = pat.CreateEQ3Band(200.0, 3.0, 1000.0, -2.0, 8000.0, 2.0)
    ref_eq = ref.CreateEQ3Band(200.0, 3.0, 1000.0, -2.0, 8000.0, 2.0)
    o = eq.applylowband(chunks[0].copy())
    g = ref_eq.applylowband(chunks[0].copy())
    assert snr_db(np.asarray(g), o) > 65.0  # float32 IIR vs reference float64

    # utility round trips
    assert abs(pat.InfodBV(sig) - ref.InfodBV(sig)) < 1e-5
    combined = pat.CombineChunks(chunks)
    assert combined.shape[0] == 512 * 8


def test_compat_makechunks_quirk():
    """MakeChunks pads by chunk-count divisibility (Utility.py:23):
    1000 samples at chunk 512 -> 2 chunks of 500 (verified vs reference)."""
    import pyaudiodsptools_tpu.compat as pat

    pat.config.initialize(44100, 512)
    ref = ref_config(44100, 512)
    sig = np.arange(1000, dtype=np.float32)
    ours = pat.MakeChunks(sig.copy())
    golden = ref.MakeChunks(sig.copy())
    assert [len(c) for c in ours] == [len(c) for c in golden] == [500, 500]
    for a, b in zip(ours, golden):
        np.testing.assert_array_equal(a, b)


def test_render_file_roundtrip(tmp_path):
    from pyaudiodsptools_tpu import render_file
    from pyaudiodsptools_tpu.core import generators

    cfg = EngineConfig(sample_rate=44100, block_size=4096)
    chain = Chain([ops.lowcut(cfg, 800)])
    in_path = str(tmp_path / "in.wav")
    wavio.write_wav(in_path, generators.demo_signal(264600, 44100), 44100)
    out_path = str(tmp_path / "out.wav")
    out = render_file(chain, in_path, out_path, cfg)
    audio, rate = wavio.read_wav(out_path)
    assert rate == 44100
    assert audio.shape == out.shape
    assert snr_db(np.clip(out, -1, 1), audio) > 50.0  # int16 quantization of a quiet signal


def test_render_segmented_matches_streamed_semantics():
    """Bounded-memory segmented render must equal the streaming fold
    (exactly — it IS the step path) and match the offline render within
    float tolerance."""
    import numpy as np
    import jax.numpy as jnp
    from pyaudiodsptools_tpu import Chain, EngineConfig, ops, render
    from pyaudiodsptools_tpu.engine.render import render_segmented
    from ref_loader import snr_db

    cfg = EngineConfig(44100, 512)
    chain = Chain([ops.lowcut(cfg, 300.0), ops.compressor(cfg, -18.0, 0.6),
                   ops.delay(cfg, 40.0, 2)])
    rng = np.random.default_rng(17)
    sig = (rng.standard_normal((2, 512 * 21 + 100)) * 0.3).astype(np.float32)

    seg = np.asarray(render_segmented(chain, sig, cfg, segment_blocks=5))
    off = np.asarray(render(chain, sig, cfg))
    assert seg.shape == off.shape
    assert snr_db(off, seg) > 100.0

    # streaming fold (the semantics render_segmented must reproduce exactly)
    st = chain.init_state((2,))
    blocks = np.pad(sig, ((0, 0), (0, (-sig.shape[-1]) % 512))
                    ).reshape(2, -1, 512)
    outs = []
    for i in range(blocks.shape[1]):
        st, o = chain.step(st, jnp.asarray(blocks[:, i]))
        outs.append(np.asarray(o))
    stream = np.concatenate(outs, axis=-1)
    assert np.array_equal(seg, stream)


def test_chain_warns_on_backend_mismatch(monkeypatch):
    """A Chain built under one backend must warn loudly when first used
    under another (its fusion structure was planned at build time)."""
    import warnings

    import jax.numpy as jnp
    import numpy as np

    from pyaudiodsptools_tpu import Chain, EngineConfig, ops

    cfg = EngineConfig(44100, 512)
    chain = Chain([ops.lowcut(cfg, 200.0)])
    chain._built_backend = "gpu"  # simulate a build under another backend
    blocks = jnp.asarray(np.zeros((2, 4, 512), np.float32))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        chain.render_blocks(blocks)
        msgs = [str(x.message) for x in w]
    assert any("built while the JAX backend" in m for m in msgs), msgs
    # one-shot: no repeat warning
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        chain.render_blocks(blocks)
    assert not any("built while the JAX backend" in str(x.message)
                   for x in w)


def test_settings_registry_covers_all_env_vars():
    """Every environment variable read anywhere in the package must be
    documented in core/settings.REGISTRY (and vice versa: no stale registry
    rows)."""
    import pathlib
    import re

    import pyaudiodsptools_tpu
    from pyaudiodsptools_tpu.core.settings import REGISTRY, snapshot

    pkg = pathlib.Path(pyaudiodsptools_tpu.__file__).parent
    used = set()
    for f in pkg.rglob("*.py"):
        used |= set(re.findall(
            r"(?:environ\.get\(|environ\[|getenv\()\s*\"([A-Z0-9_]+)\"",
            f.read_text()))
    registered = {s.name for s in REGISTRY}
    assert used, "the scan found no environment reads at all"
    assert not used - registered, f"undocumented env vars: {used - registered}"
    assert not registered - used, \
        f"registry rows with no reader: {registered - used}"
    snap = snapshot()
    assert set(snap) == registered


@pytest.mark.parametrize("env_dir", [None, "cache_from_env"])
def test_compile_cache_location(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX keeps its cache there and the
    helper changes nothing; without it the cache goes to the fixed
    <checkout>/.jax_cache, which .gitignore lists."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(root))
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax; from pyaudiodsptools_tpu.core import settings; "
            "print(settings.enable_compile_cache()); "
            "print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    returned, configured = r.stdout.split()
    want = str(tmp_path / env_dir) if env_dir else str(root / ".jax_cache")
    assert returned == configured == want
    if not env_dir:
        assert ".jax_cache/" in (root / ".gitignore").read_text().split()
