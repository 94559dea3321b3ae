"""Device-mesh construction for multi-chip / multi-host rendering.

The mesh axes (SURVEY.md §2.4, §5):
  * ``channel`` — the DP-analog: independent audio channels, embarrassingly
    parallel, no communication.
  * ``time`` — the SP/CP-analog: audio blocks sharded along time. FIR/overlap-
    save windows need only a fixed 2-block halo from the left neighbor (the
    reference's history window, EffectFFTFilter.py:40-42); delay/reverb taps
    ride the same shifted-slice collectives. GSPMD lowers these to
    collective-permutes between neighbouring devices.

The reference has no parallelism of any kind (single thread, single process);
these axes make its two implicit parallel dimensions (channels, chunk sequence)
explicit and first-class.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(channel: int | None = None, time: int = 1,
              devices=None) -> Mesh:
    """Build a ('channel', 'time') mesh over the available devices.

    With no arguments, all devices go to the channel axis (pure DP — the
    right default for many-channel workloads).
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if channel is None:
        channel = n // time
    if channel * time > n:
        raise ValueError(f"mesh {channel}x{time} needs more than {n} devices")
    arr = np.asarray(devices[: channel * time]).reshape(channel, time)
    return Mesh(arr, axis_names=("channel", "time"))


def single_device_mesh() -> Mesh:
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                axis_names=("channel", "time"))
