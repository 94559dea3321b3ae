"""Streaming benchmark: per-block step latency through the full 8-effect
chain — the reference's realtime scenario (PyAudio callback budget:
512 samples @ 44.1 kHz = 11.6 ms, ModuleTests.py:24).

Measures the pipelined per-step cost: N state-carried steps are dispatched
back-to-back (each depends on the previous state, so they serialize on
device) and the clock stops on ``block_until_ready`` of the last output.

Prints ONE JSON line like bench.py.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pyaudiodsptools_tpu import EngineConfig
    from pyaudiodsptools_tpu.core import settings
    from __graft_entry__ import _chain8

    settings.enable_compile_cache()
    cfg = EngineConfig(sample_rate=44100, block_size=args.block)
    chain = _chain8(cfg)
    C, B, N = args.channels, args.block, args.steps

    blocks = jax.jit(lambda k: jnp.clip(
        0.3 * jax.random.normal(k, (8, C, B), jnp.float32), -0.99, 0.99)
    )(jax.random.key(0))
    state = chain.init_state((C,))
    # warm up (compile the step)
    state, out = chain.step(state, blocks[0])
    assert np.isfinite(float(jnp.max(jnp.abs(out))))

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        st = state
        for i in range(N):
            st, out = chain.step(st, blocks[i % 8])
        out.block_until_ready()
        runs.append((time.perf_counter() - t0) / N)
    dt = min(runs)

    budget = B / cfg.sample_rate
    result = {
        "metric": f"8-effect chain streaming step, {C} channels",
        "value": round(dt * 1e3, 4),
        "unit": "ms/block",
        "vs_baseline": round(budget * 1e3 / (dt * 1e3), 1),  # x realtime budget
        "detail": {
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
            "block_size": B,
            "budget_ms": round(budget * 1e3, 2),
            "channels": C,
            "samples_per_s": round(C * B / dt, 1),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
