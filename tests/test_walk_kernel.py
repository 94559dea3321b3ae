"""The dynamics walk kernel in Pallas interpret mode against the serial
scan: output and exit states bit-equal, for each op and cascade order,
channel count and segmentation (segments=None is the automatic choice)."""

import numpy as np
import pytest
import jax.numpy as jnp

from pyaudiodsptools_tpu import EngineConfig, ops
from pyaudiodsptools_tpu.kernels import dynamics_walk as dw

CASCADES = {
    "compressor": ("compressor",),
    "gate": ("gate",),
    "compressor>gate": ("compressor", "gate"),
    "gate>compressor": ("gate", "compressor"),
}


def make_ops(names):
    cfg = EngineConfig(44100, 512)
    made = {"compressor": ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1),
            "gate": ops.gate(cfg, -45.0, 0.1, 3.1, 200.1)}
    return [made[n] for n in names]


def bursty(C, n, seed):
    """Loud bursts over quiet noise and stretches of silence: every
    automaton mode, including completed releases, occurs."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((C, n)) * 0.02).astype(np.float32)
    x[:, n // 2: n // 2 + 2000] = 0.0
    for start in range(0, n, 2500):
        w = min(600, n - start)
        x[:, start:start + w] += (rng.standard_normal((C, w)) * 0.7
                                  ).astype(np.float32)
    return np.clip(x, -0.99, 0.99)


def scan_fold(effects, x):
    states, out = [], jnp.asarray(x)
    for e in effects:
        st, out = e.step(e.params, e.init_state(e.params, (x.shape[0],)), out)
        states.append(st)
    return states, np.asarray(out)


@pytest.mark.parametrize("segments", [1, 5, None])
@pytest.mark.parametrize("C", [1, 3, 64])
@pytest.mark.parametrize("cascade", list(CASCADES))
def test_walk_offline_bit_equals_scan(cascade, C, segments):
    effects = make_ops(CASCADES[cascade])
    x = bursty(C, 12000, seed=C)
    states, want = scan_fold(effects, x)
    out, z, sweeps = dw.walk_offline([e.params for e in effects],
                                     jnp.asarray(x), segments=segments,
                                     interpret=True)
    np.testing.assert_array_equal(want, np.asarray(out))
    for j, (e, st) in enumerate(zip(effects, states)):
        np.testing.assert_array_equal(
            np.asarray(z[j]), np.asarray(dw.encode_state(e.params, st)))
        decoded = dw.decode_state(e.params, z[j])
        for k in ("mode", "x", "y", "skip"):
            np.testing.assert_array_equal(np.asarray(decoded[k]),
                                          np.asarray(st[k]))
    assert 1 <= int(sweeps) <= (segments or 12000)
