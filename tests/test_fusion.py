"""LTI chain fusion (engine/chain.fuse_lti_runs + ops/fft_filter.fir) and the
speculative segment-parallel dynamics walk (kernels/dynamics_walk)."""

import numpy as np
import pytest
import jax.numpy as jnp

from pyaudiodsptools_tpu import Chain, EngineConfig, ops
from pyaudiodsptools_tpu.kernels.dynamics_walk import walk_effect, walk_offline

from ref_loader import snr_db


def _fir_effects(cfg):
    return [
        ops.lowcut(cfg, 120.0),
        ops.highcut(cfg, 12000.0),
        ops.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5),
    ]


def test_fused_offline_matches_unfused():
    cfg = EngineConfig(44100, 512)
    fused = Chain(_fir_effects(cfg), fuse=True)
    plain = Chain(_fir_effects(cfg), fuse=False)
    assert len(fused.exec_effects) == 1
    assert len(plain.exec_effects) == 3

    rng = np.random.default_rng(0)
    blocks = jnp.asarray(
        (rng.standard_normal((2, 20, 512)) * 0.3).astype(np.float32))
    a = np.asarray(fused.render_blocks(blocks))
    b = np.asarray(plain.render_blocks(blocks))
    assert snr_db(b, a) > 100.0


def test_fused_streaming_matches_unfused_and_offline():
    cfg = EngineConfig(44100, 512)
    fused = Chain(_fir_effects(cfg), fuse=True)
    plain = Chain(_fir_effects(cfg), fuse=False)

    rng = np.random.default_rng(1)
    blocks = jnp.asarray(
        (rng.standard_normal((2, 12, 512)) * 0.3).astype(np.float32))
    sf, sp = fused.init_state((2,)), plain.init_state((2,))
    outs_f, outs_p = [], []
    for i in range(12):
        sf, bf = fused.step(sf, blocks[:, i])
        sp, bp = plain.step(sp, blocks[:, i])
        outs_f.append(np.asarray(bf))
        outs_p.append(np.asarray(bp))
    # compare whole streams (individual early blocks are pure latency zeros)
    f, p = np.stack(outs_f, axis=1), np.stack(outs_p, axis=1)
    assert snr_db(p, f) > 100.0
    offline = np.asarray(fused.render_blocks(blocks))
    assert snr_db(offline, f) > 100.0


def test_fusion_skips_nonlti_and_short_runs():
    cfg = EngineConfig(44100, 512)
    chain = Chain([
        ops.lowcut(cfg, 120.0),          # run of 1: kept as-is
        ops.compressor(cfg),              # non-LTI boundary
        ops.highcut(cfg, 9000.0),
        ops.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5),
    ])
    names = [e.name for e in chain.exec_effects]
    assert names[0] == "lowcut" and names[1] == "compressor"
    assert len(names) == 3 and names[2].startswith("fir_cascade")


def test_generic_fir_matches_numpy_convolution():
    from pyaudiodsptools_tpu.ops.fft_filter import fir

    rng = np.random.default_rng(2)
    kernel = rng.standard_normal(700) / 700.0
    eff = fir(kernel, 256)
    x = (rng.standard_normal((3, 8, 256)) * 0.5).astype(np.float32)
    got = np.asarray(eff.offline(eff.params, jnp.asarray(x)))
    want = np.stack([
        np.convolve(x[c].reshape(-1), kernel)[: 8 * 256] for c in range(3)
    ]).reshape(3, 8, 256)
    assert snr_db(want.astype(np.float32), got) > 100.0


@pytest.mark.parametrize("mk", [
    lambda cfg: [ops.lowcut(cfg, 200.0), ops.delay(cfg, 40.0, 2)],
    lambda cfg: [ops.delay(cfg, 30.0, 2, wet=True), ops.highcut(cfg, 9000.0)],
    lambda cfg: [ops.lowcut(cfg, 300.0), ops.reverb(cfg, 120.0)],
    lambda cfg: [ops.delay(cfg, 25.0, 2, use_lowcut_filter=True,
                           lowcut_hz=100.0), ops.highcut(cfg, 8000.0)],
])
def test_delay_reverb_fuse(mk):
    cfg = EngineConfig(44100, 512)
    fused = Chain(mk(cfg), fuse=True)
    plain = Chain(mk(cfg), fuse=False)
    assert len(fused.exec_effects) == 1

    rng = np.random.default_rng(3)
    blocks = jnp.asarray(
        (rng.standard_normal((2, 24, 512)) * 0.3).astype(np.float32))
    a = np.asarray(fused.render_blocks(blocks))
    b = np.asarray(plain.render_blocks(blocks))
    assert snr_db(b, a) > 90.0


# --- speculative segment-parallel dynamics -------------------------------

def _signals(n):
    rng = np.random.default_rng(42)
    yield "bursty", (rng.standard_normal((2, n)) * 0.3 *
                     (rng.random((2, n)) > 0.5)).astype(np.float32)
    # adversarial: hovers around threshold with no sync windows anywhere,
    # forcing the sweep loop toward its serial worst case
    yield "alternating", np.tile([0.9, 1e-4], n // 2)[None, :].repeat(
        2, 0).astype(np.float32)
    yield "silence", np.zeros((2, n), np.float32)


@pytest.mark.parametrize("factory,kwargs", [
    (ops.compressor, dict(threshold_db=-18.0, ratio=0.6)),
    (ops.gate, dict(threshold_db=-45.0, depth=0.1)),
])
@pytest.mark.parametrize("segments", [1, 5, 16])
def test_spec_dynamics_matches_scan(factory, kwargs, segments):
    cfg = EngineConfig(44100, 512)
    eff = factory(cfg, **kwargs)
    n = 30000
    for name, sig in _signals(n):
        x = jnp.asarray(sig)
        st = eff.init_state(eff.params, (2,))
        _, want = eff.step(eff.params, st, x)
        got, _, _ = walk_offline([eff.params], x, segments=segments,
                                 interpret=True)
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got),
                                      err_msg=f"{name} segments={segments}")


def test_spec_dynamics_short_attack_edge():
    """x_max == 1 collapses ATTACK entirely (trigger jumps straight to
    HOLD); the single-int encoding must handle it."""
    cfg = EngineConfig(44100, 512)
    eff = ops.compressor(cfg, threshold_db=-20.0, ratio=0.5,
                         attack_ms=1000.0 / 44100.0, release_ms=2.0)
    rng = np.random.default_rng(7)
    x = jnp.asarray((rng.standard_normal((1, 8000)) * 0.5
                     ).astype(np.float32))
    st = eff.init_state(eff.params, (1,))
    _, want = eff.step(eff.params, st, x)
    got, _, _ = walk_offline([eff.params], x, segments=7, interpret=True)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))


def test_dynamics_cascade_matches_scan_fold():
    """walk_effect runs compressor->gate in ONE kernel pass; must match
    folding the two faithful scans (including on a signal with no sync
    windows)."""
    cfg = EngineConfig(44100, 512)
    comp = ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1)
    gate = ops.gate(cfg, -45.0, 0.1, 3.1, 200.1)
    fused = walk_effect([comp, gate], interpret=True)

    rng = np.random.default_rng(11)
    for sig in [
        (rng.standard_normal((2, 30000)) * 0.3 *
         (rng.random((2, 30000)) > 0.5)).astype(np.float32),
        np.tile([0.9, 1e-4], 15000)[None, :].repeat(2, 0).astype(np.float32),
    ]:
        x = jnp.asarray(sig)
        st1 = comp.init_state(comp.params, (2,))
        st2 = gate.init_state(gate.params, (2,))
        _, mid = comp.step(comp.params, st1, x)
        _, want = gate.step(gate.params, st2, mid)
        got = fused.offline(fused.params, x.reshape(2, -1, 500)).reshape(2, -1)
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got))

    # one streaming step walks the block with one lane per channel
    x = jnp.asarray((rng.standard_normal((2, 4000)) * 0.4).astype(np.float32))
    st = fused.init_state(fused.params, (2,))
    _, out = fused.step(fused.params, st, x)
    st1 = comp.init_state(comp.params, (2,))
    st2 = gate.init_state(gate.params, (2,))
    _, mid = comp.step(comp.params, st1, x)
    _, want = gate.step(gate.params, st2, mid)
    assert bool(jnp.all(out == want))


@pytest.mark.parametrize("seed", range(6))
def test_random_chain_fused_matches_unfused(seed):
    """Property test over the fusion pass's composition space: a random
    effect sequence rendered through Chain(fuse=True) must match the same
    sequence with fusion disabled. On the CPU lane this sweeps LTI-run
    grouping and its interleaving with unfusable ops (dynamics fusion is
    GPU-gated; its composition runs on the card via
    test_gpu_lane.test_chain8_on_gpu_matches_cpu)."""
    from pyaudiodsptools_tpu import Chain, EngineConfig, ops

    cfg = EngineConfig(44100, 512)
    rng = np.random.default_rng(seed)
    pool = [
        lambda: ops.lowcut(cfg, float(rng.integers(80, 400))),
        lambda: ops.highcut(cfg, float(rng.integers(4000, 12000))),
        lambda: ops.delay(cfg, float(rng.integers(3, 12)), 2),
        lambda: ops.tremolo(cfg, 0.3, float(rng.integers(2, 8))),
        lambda: ops.softclipper(cfg, 0.4),
        lambda: ops.saturator(cfg, -16.0, 1.5, "soft"),
        lambda: ops.compressor(cfg, -18.0, 0.6, 3.1, 20.1),
        lambda: ops.harddistortion(cfg),
    ]
    effects = [pool[i]() for i in rng.integers(0, len(pool),
                                               size=rng.integers(3, 7))]
    blocks = jnp.asarray((rng.standard_normal((2, 8, 512)) * 0.3
                          ).astype(np.float32))
    want = np.asarray(Chain(effects, fuse=False).render_blocks(blocks))
    got = np.asarray(Chain(effects, fuse=True).render_blocks(blocks))
    # fused LTI cascades change float rounding (one conv vs N); everything
    # else in the CPU lane is either identical code or scan-exact
    err = want - got
    snr = 10 * np.log10(np.sum(want ** 2) / max(np.sum(err ** 2), 1e-30))
    assert snr > 90.0, (snr, [e.name for e in effects])


# --- lone dynamics routing (the README quick-start chain) -----------------

def _quickstart(cfg, dyn):
    return [ops.lowcut(cfg, 800.0), dyn, ops.softclipper(cfg, 0.44)]


@pytest.mark.parametrize("factory", [
    lambda cfg: ops.compressor(cfg, -18.0, 0.6),
    lambda cfg: ops.gate(cfg, -40.0),
])
def test_lone_dynamics_routes_through_kernel_on_gpu(monkeypatch, factory):
    """On the GPU backend a LONE compressor/gate (dynamics run of 1) must be
    wrapped with the walk kernel: the faithful lax.scan costs one device
    loop iteration per sample, so an unwrapped single would dominate any
    chain it appears in (the README quick-start chain is exactly this
    shape)."""
    import jax as _jax

    monkeypatch.setattr(_jax, "default_backend", lambda: "gpu")
    cfg = EngineConfig(44100, 4096)
    chain = Chain(_quickstart(cfg, factory(cfg)))
    names = [e.name for e in chain.exec_effects]
    assert len(names) == 3, names
    assert names[1].endswith("_walk"), names


def test_lone_dynamics_stays_faithful_on_cpu():
    """Off the GPU the scan path stays (the walk kernel is compiled for the
    GPU only)."""
    cfg = EngineConfig(44100, 4096)
    chain = Chain(_quickstart(cfg, ops.compressor(cfg, -18.0, 0.6)))
    assert [e.name for e in chain.exec_effects][1] == "compressor"


def test_lone_dynamics_wrapper_chain_matches_scan_chain():
    """Interpret-mode render of the quick-start chain with the compressor
    wrapped exactly as fuse_lti_runs wraps it on the GPU, vs the faithful
    scan chain — pins the wrapped structure's numerics on the CPU lane."""
    cfg = EngineConfig(44100, 512)
    comp = ops.compressor(cfg, -18.0, 0.6)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 24 * 512)) * 0.05).astype(np.float32)
    for s in range(0, x.shape[1], 3000):
        w = min(700, x.shape[1] - s)
        x[:, s:s + w] += (rng.standard_normal((2, w)) * 0.7).astype(np.float32)
    blocks = jnp.asarray(np.clip(x, -0.99, 0.99).reshape(2, 24, 512))

    fast = Chain(_quickstart(cfg, walk_effect([comp], interpret=True)),
                 fuse=False)
    plain = Chain(_quickstart(cfg, comp), fuse=False)
    got = np.asarray(fast.render_blocks(blocks))
    want = np.asarray(plain.render_blocks(blocks))
    np.testing.assert_array_equal(want, got)

    # streaming path of the wrapper (one walk per block), same structure
    sf, sp = fast.init_state((2,)), plain.init_state((2,))
    for i in range(6):
        sf, bf = fast.step(sf, blocks[:, i])
        sp, bp = plain.step(sp, blocks[:, i])
        np.testing.assert_array_equal(np.asarray(bp), np.asarray(bf))


def test_unfused_chain_still_routes_dynamics_on_gpu(monkeypatch):
    """fuse=False keeps every op separate, but on the GPU a dynamics op
    still takes the walk kernel: no path quietly runs the serial scan."""
    import jax as _jax

    monkeypatch.setattr(_jax, "default_backend", lambda: "gpu")
    cfg = EngineConfig(44100, 512)
    chain = Chain(_quickstart(cfg, ops.compressor(cfg, -18.0, 0.6)) +
                  [ops.gate(cfg, -40.0)], fuse=False)
    assert [e.name for e in chain.exec_effects] == [
        "lowcut", "compressor_walk", "softclipper", "gate_walk"]


def test_default_device_cpu_builds_scan_chain_beside_gpu(monkeypatch):
    """Under jax.default_device(cpu) a Chain plans for the CPU even when the
    GPU is JAX's default backend: the CPU reference a GPU process renders
    for comparison (chip_smoke.py, test_gpu_lane.py)."""
    import jax as _jax

    monkeypatch.setattr(_jax, "default_backend", lambda: "gpu")
    cfg = EngineConfig(44100, 512)
    assert Chain([ops.compressor(cfg)]).exec_effects[0].name.endswith("_walk")
    with _jax.default_device(_jax.devices("cpu")[0]):
        chain = Chain([ops.compressor(cfg)])
    assert chain.exec_effects[0].name == "compressor"
