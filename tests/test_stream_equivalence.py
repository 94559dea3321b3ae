"""Offline (block-parallel) paths against folding the streaming step over
the same blocks, for the ops that now run as plain XLA everywhere: the
stateless and delay/tremolo tail of the flagship chain, and the FIR
filters."""

import numpy as np
import pytest
import jax.numpy as jnp

from pyaudiodsptools_tpu import EngineConfig, ops

from ref_loader import snr_db

TAIL = {
    "delay": lambda cfg: ops.delay(cfg, 150.0, 2),
    "tremolo": lambda cfg: ops.tremolo(cfg, 0.3, 5.0),
    "softclipper": lambda cfg: ops.softclipper(cfg, 0.44),
    "saturator": lambda cfg: ops.saturator(cfg, -16.0, 1.5, "soft"),
    "harddistortion": lambda cfg: ops.harddistortion(cfg),
    "bitcrusher": lambda cfg: ops.bitcrusher(cfg),
}
FIR = {
    "lowcut": lambda cfg: ops.lowcut(cfg, 120.0),
    "highcut": lambda cfg: ops.highcut(cfg, 9000.0),
    "eq3band_fft": lambda cfg: ops.eq3band_fft(cfg, 250.0, 2.0, 1500.0,
                                               -1.5, 6000.0, 2.5),
}


def _offline_and_folded(eff, B, nb=8, seed=0):
    rng = np.random.default_rng(seed + B)
    x = (rng.standard_normal((2, nb, B)) * 0.5).astype(np.float32)
    off = np.asarray(eff.offline(eff.params, jnp.asarray(x)))
    st = eff.init_state(eff.params, (2,))
    outs = []
    for i in range(nb):
        st, o = eff.step(eff.params, st, jnp.asarray(x[:, i]))
        outs.append(np.asarray(o))
    return off, np.stack(outs, axis=1)


@pytest.mark.parametrize("B", [256, 512, 4096])
@pytest.mark.parametrize("name", list(TAIL))
def test_tail_offline_matches_folded_stream(name, B):
    off, folded = _offline_and_folded(TAIL[name](EngineConfig(44100, B)), B)
    assert off.shape == folded.shape and np.isfinite(off).all()
    # elementwise ops are the same expression on both paths; delay and
    # tremolo differ only in f32 summation / LFO evaluation order
    assert np.array_equal(off, folded) or snr_db(off, folded) > 120.0


@pytest.mark.parametrize("B", [256, 512, 1024, 4096])
@pytest.mark.parametrize("name", list(FIR))
def test_fir_offline_matches_stream(name, B):
    off, folded = _offline_and_folded(FIR[name](EngineConfig(44100, B)), B,
                                      nb=10)
    # segmented overlap-save vs minimal streaming windows: different FFT
    # sizes, the same linear convolution
    assert snr_db(off, folded) > 100.0
