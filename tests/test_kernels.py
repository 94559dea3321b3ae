"""The dynamics walk kernel (kernels/dynamics_walk.py) vs the faithful scan
implementation, in Pallas interpret mode on the CPU; the compiled kernel is
checked on the card by tests/test_gpu_lane.py and chip_smoke.py."""

import numpy as np
import pytest

from pyaudiodsptools_tpu import EngineConfig
from pyaudiodsptools_tpu.ops import compressor, gate
from pyaudiodsptools_tpu.kernels.dynamics_walk import walk_effect


def _burst(C, n, seed=3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((C, n)) * 0.02).astype(np.float32)
    for start in range(0, n, 3000):
        w = min(700, n - start)
        x[:, start : start + w] += (rng.standard_normal((C, w)) * 0.7
                                    ).astype(np.float32)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


@pytest.mark.parametrize("factory", [compressor, gate])
def test_kernel_matches_scan(factory):
    cfg = EngineConfig(44100, 512)
    base = factory(cfg)
    fast = walk_effect([base], interpret=True)

    x = _burst(4, 512 * 10)
    blocks = x.reshape(4, 10, 512)

    golden = np.asarray(base.offline(base.params, blocks))
    ours = np.asarray(fast.offline(fast.params, blocks))
    # same ramp tables, same multiply order: bit-identical
    np.testing.assert_array_equal(golden, ours)


def _check_state_carry(base, fast, x, B):
    C = x.shape[0]
    b_state = base.init_state(base.params, (C,))
    (f_state,) = fast.init_state(fast.params, (C,))
    for i in range(x.shape[1] // B):
        blk = x[:, i * B : (i + 1) * B]
        b_state, b_out = base.step(base.params, b_state, blk)
        (f_state,), f_out = fast.step(fast.params, (f_state,), blk)
        np.testing.assert_array_equal(np.asarray(b_out), np.asarray(f_out))
    for k in ("mode", "x", "y", "skip"):
        np.testing.assert_array_equal(np.asarray(b_state[k]),
                                      np.asarray(f_state[k]))


def test_kernel_state_carry():
    """Kernel streaming steps must agree with the scan's carried state."""
    cfg = EngineConfig(44100, 512)
    base = compressor(cfg)
    fast = walk_effect([base], interpret=True)
    _check_state_carry(base, fast, _burst(2, 512 * 6, seed=9), 512)


def test_kernel_state_carry_nonmultiple_block():
    """Block length not a multiple of the walk's rows-ahead unroll: the
    static tail rows must advance the state exactly like the scan."""
    cfg = EngineConfig(44100, 1500)
    base = compressor(cfg, -18.0, 0.6)
    fast = walk_effect([base], interpret=True)
    _check_state_carry(base, fast, _burst(2, 1500 * 6, seed=13), 1500)
