"""The GPU lane: compiled kernels and the GPU paths, on a real card.

Run on a machine with an NVIDIA GPU:

    PADT_TEST_PLATFORM=gpu python -m pytest tests/test_gpu_lane.py

Every test takes the ``gpu`` fixture, which skips when JAX finds no GPU (the
CPU lane). The check happens in the fixture, never at import, so every
pytest worker collects the same tests.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pyaudiodsptools_tpu import Chain, EngineConfig, StreamProcessor, ops
from pyaudiodsptools_tpu.kernels import dynamics_walk as dw

from ref_loader import snr_db

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (PADT_TEST_PLATFORM=gpu)")


def _signal(C, n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((C, n)) * 0.02).astype(np.float32)
    for start in range(0, n, 3000):
        w = min(700, n - start)
        x[:, start:start + w] += (rng.standard_normal((C, w)) * 0.7
                                  ).astype(np.float32)
    return np.clip(x, -0.99, 0.99)


def _chain8(cfg):
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


@pytest.mark.parametrize("order", ["compressor,gate", "gate,compressor"])
def test_walk_compiled_equals_scan(gpu, order):
    cfg = EngineConfig(44100, 512)
    effs = {"compressor": ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1),
            "gate": ops.gate(cfg, -45.0, 0.1, 3.1, 200.1)}
    effs = [effs[n] for n in order.split(",")]
    x = jnp.asarray(_signal(64, 44100 * 3))
    out, z, _ = jax.jit(lambda x: dw.walk_offline(
        [e.params for e in effs], x))(x)
    want = x
    for j, e in enumerate(effs):
        st, want = e.step(e.params, e.init_state(e.params, (64,)), want)
        np.testing.assert_array_equal(np.asarray(z[j]),
                                      np.asarray(dw.encode_state(e.params, st)))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(out))


def test_walk_stream_step_equals_scan(gpu):
    cfg = EngineConfig(44100, 512)
    comp = ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1)
    fast = dw.walk_effect([comp])
    x = _signal(64, 512 * 20, seed=4)
    sw = fast.init_state(fast.params, (64,))
    ss = comp.init_state(comp.params, (64,))
    step = jax.jit(fast.step)
    for i in range(20):
        blk = jnp.asarray(x[:, i * 512:(i + 1) * 512])
        sw, ow = step(fast.params, sw, blk)
        ss, os_ = comp.step(comp.params, ss, blk)
        np.testing.assert_array_equal(np.asarray(os_), np.asarray(ow))
    for k in ss:
        np.testing.assert_array_equal(np.asarray(ss[k]), np.asarray(sw[0][k]))


def test_chain8_on_gpu_matches_cpu(gpu):
    cfg = EngineConfig(44100, 4096)
    x = jnp.asarray(_signal(4, 4096 * 40, seed=2)).reshape(4, 40, 4096)
    chain = _chain8(cfg)
    assert any(e.name.endswith("_walk") for e in chain.exec_effects)
    got = np.asarray(chain.render_blocks(x))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref_chain = _chain8(cfg)
        assert not any(e.name.endswith("_walk")
                       for e in ref_chain.exec_effects)
        want = np.asarray(ref_chain.render_blocks(
            jax.device_put(np.asarray(x), cpu)))
    assert snr_db(want, got) >= 60.0


def test_segmented_conv_on_gpu_vs_float64(gpu):
    from pyaudiodsptools_tpu.ops import fft_filter

    rng = np.random.default_rng(5)
    k = rng.standard_normal(6145) / 100.0
    eff = fft_filter.fir(k, 4096)
    x = rng.standard_normal((2, 20 * 4096)).astype(np.float32)
    got = np.asarray(eff.offline(eff.params, jnp.asarray(x).reshape(2, 20, 4096)))
    want = np.stack([np.convolve(r.astype(np.float64), k)[: x.shape[1]]
                     for r in x])
    assert snr_db(want, got.reshape(2, -1)) >= 100.0


def test_stream_processor_on_gpu_matches_offline(gpu):
    cfg = EngineConfig(44100, 512)
    x = _signal(8, 512 * 30, seed=6).reshape(8, 30, 512)
    sp = StreamProcessor(_chain8(cfg), cfg, (8,))
    stream = np.stack([sp.process(x[:, i]) for i in range(30)], axis=1)
    offline = np.asarray(_chain8(cfg).render_blocks(jnp.asarray(x)))
    assert snr_db(offline, stream) >= 60.0
