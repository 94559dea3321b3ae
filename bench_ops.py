"""Per-op timing harness — the reference's ModuleTests.py timing pattern:
every effect timed over generated audio, reporting ms/block, realtime
factor, and (with --roofline) the modeled device-memory bytes and float32
flops next to the measured time as a % of the device's published peaks, with
the binding resource named (pyaudiodsptools_tpu/roofline.py; SURVEY.md §5's
"cost model check vs roofline" mandate).

Usage:  python bench_ops.py [--channels C] [--seconds S] [--block B]
                            [--json] [--roofline] [--chain]
Each op is timed as a one-op Chain executes it (so compressor/gate take the
walk kernel where core.settings.use_walk_kernel() says so). --chain
additionally times each exec-effect stage of the flagship 8-effect chain
(fused conv, dynamics walk, delay, tremolo, softclipper) separately.
--roofline needs a device listed in roofline.PEAKS and fails elsewhere.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _timed(fn, args, n_chain=8, reps=3):
    """Chain n data-dependent passes (pass i+1 consumes pass i's output),
    stop the clock on block_until_ready, take the best of reps."""
    out = fn(*args).block_until_ready()
    assert np.isfinite(float(abs(out).max()))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        o = out
        for _ in range(n_chain):
            o = fn(args[0], args[1], o, args[3])
        o.block_until_ready()
        times.append((time.perf_counter() - t0) / n_chain)
    return min(times)


def _best_of(fn, *args, reps=3, n=8):
    fn(*args).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            o = fn(*args)
        o.block_until_ready()
        times.append((time.perf_counter() - t0) / n)
    return min(times)


def _calibrate(pk):
    """Achieved-peak calibration: a big device-memory copy and a big bf16
    matmul. The roofline % columns use published peaks; these rows show what
    this card sustains, so 'x% of peak' can be read against the achievable
    ceiling."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((64, 2 * 1024 * 1024), jnp.float32)  # 512 MB
    copy = jax.jit(lambda a: a * jnp.float32(1.000001))  # read + write
    hbm = 2 * x.size * 4 / _best_of(copy, x)

    m = 8192
    a = jnp.ones((m, m), jnp.bfloat16)
    mm = jax.jit(lambda a: jnp.dot(a, a, preferred_element_type=jnp.float32))
    flops = 2 * m ** 3 / _best_of(mm, a)
    return {
        "hbm_copy_gbps": round(hbm / 1e9, 1),
        "hbm_copy_pct_of_peak": round(100 * hbm / pk.hbm_bytes_per_s, 1),
        "tensor_bf16_tflops": round(flops / 1e12, 1),
        "tensor_pct_of_peak": round(100 * flops / pk.tensor_bf16_flops, 1),
    }


def _op_model(eff, C, T):
    """The roofline cost model matching this exec-effect's path."""
    from pyaudiodsptools_tpu import roofline as rl
    from pyaudiodsptools_tpu.parallel.dynspec import is_dynamics_params

    p = eff.params
    if is_dynamics_params(p):
        if eff.name.endswith("_walk"):
            return rl.dynamics_cost(C, T, n_ops=len(p))
        # faithful scan: one read+write, ~30 dependent ops/sample
        return rl.simple_cost(C, T, flops_per_sample=30.0)
    conv = rl.conv_cost_from_params(C, T, p)
    if conv is not None:
        return conv
    if eff.name == "delay":
        taps = 1 + getattr(p, "feedback_loops", 1)
        return rl.simple_cost(C, T, read_passes=float(taps))
    return rl.simple_cost(C, T)


def _chain_stages(cfg, blocks, pk, eps, roofline):
    """Time each exec-effect of the flagship chain separately."""
    import jax

    from pyaudiodsptools_tpu import roofline as rl
    from __graft_entry__ import _chain8

    chain = _chain8(cfg)
    C = blocks.shape[0]
    T = blocks.shape[-2] * blocks.shape[-1]
    rows = {}
    for eff in chain.exec_effects:
        fn = jax.jit(lambda p, b, o, e, _f=eff.offline: _f(p, b + e * o))
        dt = _timed(fn, (eff.params, blocks, blocks, eps))
        rows[eff.name] = {"ms": round(dt * 1e3, 3)}
        if roofline:
            rows[eff.name].update(rl.classify(dt, _op_model(eff, C, T), pk))
    fn = jax.jit(lambda p, b, o, e: chain._jit_render(p, b + e * o))
    dt = _timed(fn, (chain.params, blocks, blocks, eps))
    rows["chain8_total"] = {"ms": round(dt * 1e3, 3)}
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="attach cost models + roofline %% per op")
    ap.add_argument("--chain", action="store_true",
                    help="also decompose the flagship chain's stages")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pyaudiodsptools_tpu import Chain, EngineConfig, ops
    from pyaudiodsptools_tpu import roofline as rl
    from pyaudiodsptools_tpu.core import settings

    settings.enable_compile_cache()
    dev = jax.devices()[0]
    pk = rl.peaks_for(dev.device_kind) if args.roofline else None

    cfg = EngineConfig(sample_rate=44100, block_size=args.block)
    n = int(args.seconds * cfg.sample_rate)
    nb = -(-n // cfg.block_size)
    lead = (args.channels,) if args.channels > 1 else ()
    key = jax.random.key(0)
    blocks = jax.jit(lambda k: jnp.clip(
        0.3 * jax.random.normal(k, lead + (nb, cfg.block_size), jnp.float32),
        -0.99, 0.99))(key)
    total = blocks.size
    C = args.channels
    T = nb * cfg.block_size

    ops_under_test = {
        "saturator": ops.saturator(cfg),
        "compressor": ops.compressor(cfg),
        "delay": ops.delay(cfg, 500, 2),
        "tremolo": ops.tremolo(cfg),
        "harddistortion": ops.harddistortion(cfg),
        "gate": ops.gate(cfg),
        "lowcut": ops.lowcut(cfg, 160),
        "highcut": ops.highcut(cfg, 8000),
        "eq3band_fft": ops.eq3band_fft(cfg, 200, 3.0, 1000, -2.0, 8000, 2.0),
        "eq3band_biquad": ops.eq3band(cfg, 200, 3.0, 1000, -2.0, 8000, 2.0),
        "softclipper": ops.softclipper(cfg),
        "bitcrusher": ops.bitcrusher(cfg),
        "reverb": ops.reverb(cfg, 1500),
    }

    results = {}
    budget_ms = cfg.block_duration_ms
    eps = jnp.float32(1e-6)
    for name, op in ops_under_test.items():
        (eff,) = Chain([op]).exec_effects
        fn = jax.jit(lambda p, b, o, e, _f=eff.offline: _f(p, b + e * o))
        dt = _timed(fn, (eff.params, blocks, blocks, eps))
        ms_per_block = 1000.0 * dt / nb
        results[name] = {
            "path": eff.name,
            "ms_per_block": round(ms_per_block, 5),
            "realtime_factor": round((total / cfg.sample_rate) / dt, 1),
            "samples_per_s": round(total / dt, 1),
        }
        if args.roofline:
            results[name].update(rl.classify(dt, _op_model(eff, C, T), pk))
        if not args.json:
            extra = (f"  [{results[name].get('bound', '')}]"
                     if args.roofline else "")
            print(f"{name:18s} {ms_per_block:10.5f} ms/block "
                  f"(budget {budget_ms:.2f})  "
                  f"{results[name]['realtime_factor']:12.1f}x realtime{extra}")

    payload = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                          "count": len(jax.devices())},
               "channels": args.channels,
               "block_size": args.block,
               "seconds": args.seconds,
               "results": results}
    if args.roofline:
        payload["peaks"] = {"tensor_bf16_flops": pk.tensor_bf16_flops,
                            "fp32_flops": pk.fp32_flops,
                            "hbm_bytes_per_s": pk.hbm_bytes_per_s}
        payload["calibration"] = _calibrate(pk)
    if args.chain:
        chain_cfg = EngineConfig(sample_rate=44100, block_size=4096)
        nbc = -(-int(30.0 * 44100) // 4096)
        cblocks = jax.jit(lambda k: jnp.clip(
            0.3 * jax.random.normal(k, (64, nbc, 4096), jnp.float32),
            -0.99, 0.99))(key)
        payload["chain_stages"] = _chain_stages(chain_cfg, cblocks, pk, eps,
                                                args.roofline)
        if not args.json:
            for k, v in payload["chain_stages"].items():
                print(f"chain[{k}]: {v}")

    if args.json:
        print(json.dumps(payload))


if __name__ == "__main__":
    main()
