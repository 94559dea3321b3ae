"""The walk kernel's streaming step (one lane per channel, state carried
across blocks through the encode/decode round trip) against the scan's
step, in Pallas interpret mode."""

import numpy as np
import pytest
import jax.numpy as jnp

from pyaudiodsptools_tpu.kernels.dynamics_walk import walk_effect

from test_walk_kernel import CASCADES, bursty, make_ops


@pytest.mark.parametrize("cascade", list(CASCADES))
@pytest.mark.parametrize("B", [64, 512])
def test_walk_stream_state_carry(B, cascade):
    effects = make_ops(CASCADES[cascade])
    fast = walk_effect(effects, interpret=True)
    C = 3
    x = bursty(C, 6 * B, seed=B)
    f_state = fast.init_state(fast.params, (C,))
    s_states = [e.init_state(e.params, (C,)) for e in effects]
    for i in range(6):
        blk = jnp.asarray(x[:, i * B:(i + 1) * B])
        f_state, f_out = fast.step(fast.params, f_state, blk)
        out = blk
        for j, e in enumerate(effects):
            s_states[j], out = e.step(e.params, s_states[j], out)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(f_out))
        for fs, ss in zip(f_state, s_states):
            for k in ("mode", "x", "y", "skip"):
                np.testing.assert_array_equal(np.asarray(fs[k]),
                                              np.asarray(ss[k]))
