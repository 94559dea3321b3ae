"""Multi-process distributed execution: 2 real processes, CPU backend.

Executes ``parallel/dist.py`` end-to-end the way a multi-host job uses it —
``jax.distributed.initialize`` with a real coordinator, a global mesh
spanning both processes' devices, per-host channel I/O — and asserts the
assembled output equals a single-process render of the same chain
(SURVEY.md §4 point 3: multi-host tests without a cluster)."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ref_loader import snr_db

_DEV_PER_PROC = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_render(tmp_path):
    worker = Path(__file__).with_name("dist_worker.py")
    port = _free_port()
    outs = [tmp_path / f"out{i}.npy" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port),
             str(_DEV_PER_PROC), str(outs[i])],
            cwd=str(Path(__file__).resolve().parent.parent),
            env={**os.environ,
                 "PYTHONPATH": str(Path(__file__).resolve().parent.parent)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    logs = []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=300)
            logs.append(log)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"

    got = np.concatenate([np.load(o) for o in outs], axis=0)

    # Single-process golden of the identical chain/signal (worker constants).
    import jax.numpy as jnp

    from pyaudiodsptools_tpu import Chain, EngineConfig, ops, render

    cfg = EngineConfig(sample_rate=44100, block_size=512)
    chain = Chain([
        ops.lowcut(cfg, 200.0),
        ops.tremolo(cfg, 0.3, 5.0),
        ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1),
        ops.softclipper(cfg, 0.44),
    ])
    rng = np.random.default_rng(11)
    sig = (rng.standard_normal((4, 512 * 8)) * 0.4).astype(np.float32)
    golden = np.asarray(render(chain, jnp.asarray(sig), cfg))[:, : sig.shape[1]]

    assert got.shape == golden.shape
    assert (np.array_equal(golden, got)
            or snr_db(golden, got) > 100.0), snr_db(golden, got)
