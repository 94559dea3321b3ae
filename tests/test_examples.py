"""Smoke-run the example scripts in-process (the conftest platform
applies). Each example must run to completion and produce sane output; the
file examples write their generated input and their output into tmp_path."""

import os
import runpy
import sys
import wave

import numpy as np
import pytest

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _run(name, *argv, monkeypatch=None):
    if monkeypatch is not None:
        monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(os.path.join(EXAMPLES, name), run_name="__main__")


def _read(path):
    with wave.open(path) as f:
        return (np.frombuffer(f.readframes(f.getnframes()), np.int16)
                .astype(np.float32) / 32768.0)


def test_example1_offline_mono(tmp_path, monkeypatch):
    _run("example1_offline_mono.py", str(tmp_path), monkeypatch=monkeypatch)
    out = _read(str(tmp_path / "output_mono.wav"))
    assert out.size >= 264600 and np.isfinite(out).all() and np.abs(out).max() > 1e-3


def test_example2_offline_stereo(tmp_path, monkeypatch):
    _run("example2_offline_stereo.py", str(tmp_path), monkeypatch=monkeypatch)
    with wave.open(str(tmp_path / "output_stereo.wav")) as f:
        assert f.getnchannels() == 2


def test_example3_realtime_stream():
    _run("example3_realtime_stream.py")


def test_example4_accelerator(tmp_path, monkeypatch):
    _run("example4_accelerator.py", str(tmp_path), monkeypatch=monkeypatch)
    out = _read(str(tmp_path / "output_accel.wav"))
    assert np.isfinite(out).all()


def test_example5_sharded_multichip():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    _run("example5_sharded_multichip.py")


def test_cli_render(tmp_path):
    from pyaudiodsptools_tpu import Chain, EngineConfig, ops, render
    from pyaudiodsptools_tpu.__main__ import main
    from pyaudiodsptools_tpu.core import generators, wavio

    src = tmp_path / "in.wav"
    wavio.write_wav(str(src), generators.demo_signal(6 * 44100, 44100), 44100)
    out = tmp_path / "cli.wav"
    rc = main([str(src), str(out),
               "--block-size", "4096",
               "--chain", '[{"op": "lowcut", "cutoff_hz": 800}]'])
    assert rc in (0, None) and out.exists()
    data = _read(str(out))
    assert data.size >= 264600 and np.isfinite(data).all()
    # the CLI output is the library render, quantized to 16 bits
    cfg = EngineConfig(44100, 4096)
    audio, _ = wavio.read_wav(str(src))
    want = np.asarray(render(Chain([ops.lowcut(cfg, 800)]), audio, cfg))
    assert np.max(np.abs(np.clip(want, -1, 1) - data)) < 2.0 / 32768
