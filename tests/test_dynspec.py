"""Cross-device speculative dynamics (parallel/dynspec.py): time-sharded
compressor/gate must equal the single-device render bit-for-bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyaudiodsptools_tpu import Chain, EngineConfig, ops, render
from pyaudiodsptools_tpu.core import block as blk
from pyaudiodsptools_tpu.parallel import make_mesh
from pyaudiodsptools_tpu.parallel.dynspec import (
    dynamics_offline_time_sharded, is_dynamics_params)


def _burst(channels, n, seed=5):
    """Loud bursts over quiet noise — drives every automaton mode, including
    mid-segment entries in ATTACK/HOLD/RELEASE."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((channels, n)) * 0.02).astype(np.float32)
    for start in range(0, n, 3000):
        seg = min(700, n - start)
        x[:, start:start + seg] += (rng.standard_normal((channels, seg)) * 0.7
                                    ).astype(np.float32)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


@pytest.mark.parametrize("time_shards", [2, 8])
def test_time_sharded_dynamics_exact(time_shards):
    if len(jax.devices()) < time_shards:
        pytest.skip("needs virtual devices")
    cfg = EngineConfig(44100, 512)
    comp = ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1)
    gate = ops.gate(cfg, -45.0, 0.1, 3.1, 200.1)

    sig = _burst(2, 512 * 16)
    blocks = blk.make_blocks(jnp.asarray(sig), 512)

    golden = blocks
    for eff in (comp, gate):
        golden = eff.offline(eff.params, golden)
    golden = np.asarray(golden)

    mesh = make_mesh(channel=1, time=time_shards)
    out = blocks
    for eff in (comp, gate):
        out = jax.jit(
            lambda p, b: dynamics_offline_time_sharded(p, b, mesh)
        )(eff.params, out)
    np.testing.assert_array_equal(golden, np.asarray(out))


def test_cascade_params_detected():
    cfg = EngineConfig(44100, 512)
    comp = ops.compressor(cfg)
    gate = ops.gate(cfg)
    assert is_dynamics_params(comp.params)
    assert is_dynamics_params((comp.params, gate.params))
    assert not is_dynamics_params(ops.tremolo(cfg).params)
    assert not is_dynamics_params(())


def test_sharded_renderer_keeps_dynamics_time_sharded():
    """End-to-end: a chain with compressor+gate renders on a time=4 mesh and
    equals the single-device render exactly (the renderer routes dynamics
    through dynspec instead of gathering the time axis)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from pyaudiodsptools_tpu.parallel import ShardedRenderer

    cfg = EngineConfig(44100, 512)

    def mk_chain():
        return Chain([
            ops.lowcut(cfg, 150.0),
            ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1),
            ops.gate(cfg, -45.0, 0.1, 3.1, 200.1),
            ops.softclipper(cfg, 0.44),
        ])

    sig = _burst(4, 512 * 16, seed=9)
    golden = np.asarray(render(mk_chain(), jnp.asarray(sig), cfg))

    mesh = make_mesh(channel=2, time=4)
    out = np.asarray(ShardedRenderer(mk_chain(), cfg, mesh).render(sig))
    np.testing.assert_array_equal(golden, out[:, : golden.shape[-1]])


def test_time_sharded_pallas_stepper_interpret():
    """The GPU branch of dynspec — the walk kernel inside shard_map inside
    while_loop, with entry states carried across devices — executes on the
    virtual mesh in interpret mode, pinning the composition on the CPU
    lane; chip_smoke.py --four-cards runs it compiled."""
    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    cfg = EngineConfig(44100, 512)
    comp = ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1)
    gate = ops.gate(cfg, -45.0, 0.1, 3.1, 200.1)

    sig = _burst(2, 512 * 8, seed=7)
    blocks = blk.make_blocks(jnp.asarray(sig), 512)
    golden = gate.offline(gate.params, comp.offline(comp.params, blocks))

    mesh = make_mesh(channel=1, time=4)
    out = jax.jit(
        lambda p, b: dynamics_offline_time_sharded(p, b, mesh, interpret=True)
    )((comp.params, gate.params), blocks)
    np.testing.assert_array_equal(np.asarray(golden), np.asarray(out))
