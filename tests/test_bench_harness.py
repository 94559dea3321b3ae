"""The benchmark harnesses are product surfaces, so CI smoke-runs them on
tiny CPU configs — a harness crash would otherwise only surface during a
run on the card."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _run(args, timeout=240):
    return subprocess.run(
        [sys.executable] + args, cwd=str(ROOT), capture_output=True,
        text=True, timeout=timeout,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": ""},
    )


def test_bench_ops_smoke_cpu():
    r = _run(["bench_ops.py", "--channels", "2", "--seconds", "1",
              "--block", "512", "--json"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    payload = json.loads(r.stdout.strip().splitlines()[-1])
    assert payload["device"]["platform"] == "cpu"
    assert "saturator" in payload["results"]
    for row in payload["results"].values():
        assert row["ms_per_block"] > 0
    # off the GPU a one-op Chain keeps the faithful scan
    assert payload["results"]["compressor"]["path"] == "compressor"


def test_bench_ops_roofline_refuses_unknown_device():
    """Roofline shares exist only against a published peak: on a device
    that is not in roofline.PEAKS the harness fails instead of dividing by
    another device's peaks."""
    r = _run(["bench_ops.py", "--channels", "2", "--seconds", "1",
              "--block", "512", "--json", "--roofline"])
    assert r.returncode != 0
    assert "no published peaks" in r.stderr
