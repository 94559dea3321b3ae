"""Smoke run of the effect engine on one NVIDIA GPU, at the size users run.

    python3 chip_smoke.py               # one card: phases 0-6 below
    python3 chip_smoke.py --four-cards  # four cards: the sharded render only

Phases, in order; any failure raises and the process exits non-zero:

  0. environment: card name and power limit (nvidia-smi), JAX version,
     device kind, XLA_FLAGS, settings, compile-cache directory. Exits
     non-zero unless JAX's first device is a GPU.
  1. compile the dynamics walk kernel and the 8-effect chain render at full
     width (64 channels x 30 s); print the render's memory analysis.
  2. walk vs serial scan on the card, same input: the offline
     compressor->gate cascade at 64 ch x 30 s, and the streaming step at
     64 ch x B=512 over 200 blocks. Outputs and exit states must be equal
     (both use the same float32 ramp tables: 0 ulp).
  3. the chain's fused FIR cascade through segmented_fft_conv on the card,
     4 channels x 30 s, against float64 np.convolve: SNR >= 100 dB.
  4. chain8 render at B=4096 and B=512, 64 ch x 30 s: 4 full-length channels
     against the same Chain run on the CPU backend in this process, SNR >=
     60 dB (the repo's parity bar; FFT rounding differs between backends).
     Prints 3 steady-state render walls per block size (smoke timings, not
     the benchmark).
  5. StreamProcessor, chain8, 64 ch, B=512, 200 blocks: against the offline
     render at >= 60 dB; p50/p99 step ms against the 11.6 ms budget.
  6. the CLI on a generated wav, against the library render.

--four-cards runs only the sharded path (README's parallel/ row, BASELINE
config 5): chain8 at 256 ch x 30 s, B=4096, on a make_mesh(channel=2,
time=2) mesh so that dynspec's time-sharded walk runs inside shard_map,
against a one-card Chain.render_blocks of the same input: SNR > 100 dB or
equal, as the CPU-mesh tests assert.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 44100
T30 = 323 * 4096          # 30 s at 44.1 kHz, whole B=4096 and B=512 blocks
CHANNELS = 64
STREAM_BLOCKS = 200
BUDGET_MS = 512 / SR * 1e3


def log(*args):
    print(*args, flush=True)


def snr_db(want, got) -> float:
    want = np.asarray(want, np.float64)
    err = np.sum((want - np.asarray(got, np.float64)) ** 2)
    return float("inf") if err == 0 else 10 * np.log10(np.sum(want ** 2) / err)


def card_name_and_limit() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip()


def signal(jax, jnp, channels, n, seed=0):
    """Noise with bursts, generated on the device: drives every automaton
    mode of compressor and gate."""
    key = jax.random.key(seed)

    @jax.jit
    def gen(key):
        noise = 0.25 * jax.random.normal(key, (channels, n), jnp.float32)
        t = jnp.arange(n, dtype=jnp.float32)
        burst = (jnp.sin(2 * jnp.pi * t / (SR // 3)) > 0.6).astype(
            jnp.float32) * 0.5 + 0.3
        return jnp.clip(noise * burst, -0.99, 0.99)

    return gen(key)


def walls(fn, n=3):
    fn().block_until_ready()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn().block_until_ready()
        out.append(time.perf_counter() - t0)
    return out


def phase0(jax):
    """Returns (nvidia-smi lines, one-line label for the timings)."""
    from pyaudiodsptools_tpu.core import settings

    cache = settings.enable_compile_cache()
    card = card_name_and_limit()
    label = " / ".join(sorted(set(card.splitlines())))
    log("phase 0: environment")
    log("  card (name, power.limit):", label)
    log("  jax", jax.__version__, "devices", jax.devices())
    log("  device_kind:", jax.devices()[0].device_kind)
    log("  XLA_FLAGS:", os.environ.get("XLA_FLAGS", ""))
    log("  settings:", settings.snapshot())
    log("  compile cache:", cache)
    return card, label


def phase1(jax, jnp, x64):
    from pyaudiodsptools_tpu import EngineConfig
    from pyaudiodsptools_tpu.kernels import dynamics_walk as dw
    from __graft_entry__ import _chain8

    log("phase 1: compile at full width")
    chain = _chain8(EngineConfig(SR, 4096))
    names = [e.name for e in chain.exec_effects]
    log("  exec effects:", names)
    assert any(n.endswith("_walk") for n in names), names
    t0 = time.perf_counter()
    (dyn,) = [e for e in chain.exec_effects if e.name.endswith("_walk")]
    jax.jit(lambda x: dw.walk_offline(dyn.params, x)).lower(x64).compile()
    log(f"  walk kernel compiled in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    blocks = x64.reshape(CHANNELS, -1, 4096)
    compiled = chain._jit_render.lower(chain.params, blocks).compile()
    log(f"  chain8 render compiled in {time.perf_counter() - t0:.1f} s")
    log("  memory_analysis:", compiled.memory_analysis())


def phase2(jax, jnp, x64, card):
    from pyaudiodsptools_tpu import EngineConfig, ops
    from pyaudiodsptools_tpu.kernels import dynamics_walk as dw

    log("phase 2: walk kernel vs serial scan on the card")
    cfg = EngineConfig(SR, 512)
    comp = ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1)
    gate = ops.gate(cfg, -45.0, 0.1, 3.1, 200.1)
    params = (comp.params, gate.params)

    def scan(x, st1, st2):
        st1, mid = comp.step(comp.params, st1, x)
        st2, out = gate.step(gate.params, st2, mid)
        return out, st1, st2

    init = lambda C: (comp.init_state(comp.params, (C,)),
                      gate.init_state(gate.params, (C,)))
    scan = jax.jit(scan)
    scan_full = scan.lower(x64, *init(CHANNELS)).compile()
    walk = jax.jit(lambda x: dw.walk_offline(params, x))

    out_w, z, sweeps = walk(x64)
    t0 = time.perf_counter()
    out_s, s1, s2 = scan_full(x64, *init(CHANNELS))
    out_s.block_until_ready()
    t_scan = time.perf_counter() - t0
    assert bool(jnp.all(out_w == out_s)), "offline walk output != scan"
    assert bool(jnp.all(z[0] == dw.encode_state(comp.params, s1)))
    assert bool(jnp.all(z[1] == dw.encode_state(gate.params, s2)))
    w = walls(lambda: walk(x64)[0])
    log(f"  offline cascade {CHANNELS} ch x {T30} samples: equal outputs and "
        f"exit states, {int(sweeps)} sweeps, "
        f"{dw.auto_segments(CHANNELS, T30)} segments")
    log(f"  smoke timings on {card}: walk {[round(t * 1e3, 3) for t in w]} ms,"
        f" scan {t_scan * 1e3:.1f} ms")

    eff = dw.walk_effect([comp, gate])
    wstep = jax.jit(eff.step)
    sstep = jax.jit(lambda b, st: scan(b, *st))
    stw = eff.init_state(eff.params, (CHANNELS,))
    sts = init(CHANNELS)
    blocks = x64[:, : STREAM_BLOCKS * 512].reshape(CHANNELS, -1, 512)
    tw, ts = [], []
    for i in range(STREAM_BLOCKS):
        t0 = time.perf_counter()
        stw, ow = wstep(eff.params, stw, blocks[:, i])
        ow.block_until_ready()
        t1 = time.perf_counter()
        os_, s1, s2 = sstep(blocks[:, i], sts)
        os_.block_until_ready()
        tw.append(t1 - t0)
        ts.append(time.perf_counter() - t1)
        sts = (s1, s2)
        assert bool(jnp.all(ow == os_)), f"stream block {i}: walk != scan"
    for j, st in enumerate(sts):
        for k in st:
            assert bool(jnp.all(stw[j][k] == st[k])), (j, k)
    log(f"  streaming step 64 ch x B=512 x {STREAM_BLOCKS}: equal outputs "
        f"and states; smoke p50 walk {np.median(tw[1:]) * 1e3:.3f} ms, "
        f"scan {np.median(ts[1:]) * 1e3:.3f} ms")


def phase3(jax, jnp, x64):
    from pyaudiodsptools_tpu import EngineConfig
    from pyaudiodsptools_tpu.ops import fft_filter
    from __graft_entry__ import _chain8

    log("phase 3: FIR cascade on the card vs float64 np.convolve")
    fir = _chain8(EngineConfig(SR, 4096)).exec_effects[0]
    p = fir.params
    x = x64[:4].reshape(4, -1, 4096)
    y = jax.jit(lambda b: fft_filter.segmented_fft_conv(
        p.spectrum_seg, b, p.lead, p.seg_unit, p.halo, p.seg))(x)
    y = np.asarray(y).reshape(4, -1)
    xs = np.asarray(x64[:4], np.float64)
    k = np.asarray(fir.lti_kernel)[p.lead:]
    want = np.stack([np.concatenate([np.zeros(p.lead),
                                     np.convolve(r, k)])[: T30] for r in xs])
    snr = snr_db(want, y)
    log(f"  {fir.name}: {len(fir.lti_kernel)} taps, 4 ch x 30 s, "
        f"SNR {snr:.2f} dB")
    assert snr >= 100.0, snr


def phase4(jax, jnp, x64, card):
    from pyaudiodsptools_tpu import EngineConfig
    from __graft_entry__ import _chain8

    log("phase 4: chain8 render, GPU vs the CPU backend")
    cpu = jax.devices("cpu")[0]
    renders = {}
    for B in (4096, 512):
        cfg = EngineConfig(SR, B)
        chain = _chain8(cfg)
        blocks = x64.reshape(CHANNELS, -1, B)
        out = np.asarray(chain.render_blocks(blocks)[:4])
        with jax.default_device(cpu):
            ref_chain = _chain8(cfg)
            ref = np.asarray(ref_chain.render_blocks(
                jax.device_put(np.asarray(blocks[:4]), cpu)))
        assert np.isfinite(out).all() and out.shape == ref.shape
        snr = snr_db(ref, out)
        w = walls(lambda: chain.render_blocks(blocks))
        renders[B] = chain
        log(f"  B={B}: SNR vs CPU {snr:.2f} dB; smoke render walls on "
            f"{card}: {[round(t * 1e3, 3) for t in w]} ms")
        assert snr >= 60.0, snr
    return renders


def phase5(jax, jnp, x64, card):
    from pyaudiodsptools_tpu import EngineConfig, StreamProcessor
    from __graft_entry__ import _chain8

    log("phase 5: StreamProcessor, chain8, 64 ch, B=512")
    cfg = EngineConfig(SR, 512)
    blocks = np.asarray(x64[:, : STREAM_BLOCKS * 512]).reshape(
        CHANNELS, STREAM_BLOCKS, 512)
    sp = StreamProcessor(_chain8(cfg), cfg, (CHANNELS,))
    sp.warmup()
    outs, times = [], []
    for i in range(STREAM_BLOCKS):
        t0 = time.perf_counter()
        outs.append(sp.process(blocks[:, i]))
        times.append(time.perf_counter() - t0)
    stream = np.stack(outs, axis=1)
    offline = np.asarray(_chain8(cfg).render_blocks(jnp.asarray(blocks)))
    snr = snr_db(offline, stream)
    p50, p99 = np.percentile(np.asarray(times) * 1e3, [50, 99])
    log(f"  stream vs offline SNR {snr:.2f} dB; step p50 {p50:.3f} ms, "
        f"p99 {p99:.3f} ms (budget {BUDGET_MS:.1f} ms) on {card}")
    assert snr >= 60.0, snr
    assert np.isfinite(stream).all()


def phase6(jax):
    from pyaudiodsptools_tpu import Chain, EngineConfig, ops, render
    from pyaudiodsptools_tpu.__main__ import main as cli
    from pyaudiodsptools_tpu.core import generators, wavio

    log("phase 6: CLI on a generated wav")
    spec = ('[{"op": "lowcut", "cutoff_hz": 160},'
            ' {"op": "compressor", "threshold_db": -18},'
            ' {"op": "gate", "threshold_db": -45},'
            ' {"op": "softclipper"}]')
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.wav"), os.path.join(d, "out.wav")
        wavio.write_wav(src, generators.demo_signal(6 * SR, SR, 2), SR)
        assert cli([src, dst, "--block-size", "512", "--chain", spec]) == 0
        got, rate = wavio.read_wav(dst)
        audio, _ = wavio.read_wav(src)
    cfg = EngineConfig(SR, 512)
    want = np.asarray(render(Chain([
        ops.lowcut(cfg, 160), ops.compressor(cfg, threshold_db=-18),
        ops.gate(cfg, threshold_db=-45), ops.softclipper(cfg)]), audio, cfg))
    err = np.max(np.abs(np.clip(want, -1, 1) - got))
    log(f"  CLI output vs library render: max abs diff {err:.2e}")
    assert rate == SR and got.shape == want.shape
    assert err <= 2.0 / 32768, err


def four_cards(jax, jnp, card):
    from pyaudiodsptools_tpu import EngineConfig
    from pyaudiodsptools_tpu.parallel import ShardedRenderer, make_mesh
    from __graft_entry__ import _chain8

    log("four cards: chain8, 256 ch x 30 s, B=4096, mesh channel=2 time=2")
    assert len(jax.devices()) == 4, jax.devices()
    cfg = EngineConfig(SR, 4096)
    x = signal(jax, jnp, 256, T30, seed=5)
    chain = _chain8(cfg)
    mesh = make_mesh(channel=2, time=2)
    renderer = ShardedRenderer(chain, cfg, mesh)
    t0 = time.perf_counter()
    # render() pads the signal to whole blocks on every time shard
    out = renderer.render(x).block_until_ready()
    log(f"  sharded render compiled and ran in "
        f"{time.perf_counter() - t0:.1f} s")
    one = np.asarray(chain.render_blocks(x.reshape(256, -1, 4096)))
    one = one.reshape(256, -1)
    out = np.asarray(out)[:, : one.shape[1]]
    equal = np.array_equal(one, out)
    snr = snr_db(one, out)
    w = walls(lambda: renderer.render(x))
    log(f"  vs one-card render: equal={equal}, SNR {snr:.2f} dB; smoke "
        f"sharded walls on {card}: {[round(t * 1e3, 3) for t in w]} ms")
    assert equal or snr > 100.0, snr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded 4-card render and its check")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    smi, card = phase0(jax)
    if args.four_cards:
        four_cards(jax, jnp, card)
    else:
        x64 = signal(jax, jnp, CHANNELS, T30)
        phase1(jax, jnp, x64)
        phase2(jax, jnp, x64, card)
        phase3(jax, jnp, x64)
        phase4(jax, jnp, x64, card)
        phase5(jax, jnp, x64, card)
        phase6(jax)
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
