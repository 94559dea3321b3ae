"""Roofline cost models (SURVEY.md §5 tracing plan: "cost model check
vs roofline" for the FFT/filter kernels; BASELINE.json restates it).

For every hot path this models the two budgets a render on the card can be
bound by — device-memory bytes moved and float32 operations — so a measured
wall time turns into "% of the bandwidth roofline" and "% of the compute
roofline", and the binding resource can be NAMED instead of guessed.
``bench_ops.py --roofline`` emits these next to the measured numbers.

Peaks are published data-sheet rates keyed by JAX's ``device_kind``; a
device that is not in the table is an error, not a default.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    tensor_bf16_flops: float   # dense bf16 on the tensor cores
    fp32_flops: float          # float32 outside the tensor cores
    hbm_bytes_per_s: float


PEAKS = {
    # NVIDIA H100 SXM data sheet (dense rates, 700 W power limit).
    "NVIDIA H100 80GB HBM3": Peaks(989e12, 67e12, 3.35e12),
}


def peaks_for(device_kind: str) -> Peaks:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "pyaudiodsptools_tpu.roofline.PEAKS with its source") from None


def conv_cost(C: int, T: int, block_size: int, halo: int, seg: int) -> dict:
    """Model of ops/fft_filter.segmented_fft_conv (XLA overlap-save).

    Each n = (halo+seg)*B window is read once — (halo+seg)/seg times the
    signal — and one signal is written. Per window: a real FFT and its
    inverse (~2.5 n log2 n flops each) and the complex spectrum multiply
    (~6 flops per bin)."""
    n = (halo + seg) * block_size
    n_windows = C * -(-T // (seg * block_size))
    flops = n_windows * (5.0 * n * math.log2(n) + 3.0 * n)
    return {"bytes": 4.0 * (n_windows * n + C * T), "flops": flops}


def conv_cost_from_params(C: int, T: int, p) -> dict | None:
    """conv_cost from an effect's params when it is FIR/segmented-backed
    (FIRParams, EQ3Band FIR-ized, eq3band_fft...)."""
    halo = getattr(p, "halo", None) or getattr(p, "halo_blocks", None)
    seg = getattr(p, "seg", None) or getattr(p, "seg_blocks", None)
    B = getattr(p, "seg_unit", None) or getattr(p, "block_size", None)
    if halo is None or seg is None or B is None:
        return None
    return conv_cost(C, T, B, halo, seg)


def simple_cost(C: int, T: int, read_passes: float = 1.0,
                write_passes: float = 1.0,
                flops_per_sample: float = 10.0) -> dict:
    return {"bytes": 4.0 * C * T * (read_passes + write_passes),
            "flops": float(C) * T * flops_per_sample}


def dynamics_cost(C: int, T: int, n_ops: int = 1, sweeps: float = 2.0,
                  ops_per_sample: float = 30.0) -> dict:
    """Dynamics walk (kernels/dynamics_walk.py): each sweep reads the
    signal and writes the output; the automaton is ~30 dependent
    int/float32 operations per sample per cascaded op."""
    return {"bytes": 4.0 * C * T * (sweeps * 2),
            "flops": float(C) * T * n_ops * sweeps * ops_per_sample}


def classify(measured_s: float, cost: dict, pk: Peaks) -> dict:
    """Attach roofline percentages and name the binding resource."""
    bw_pct = 100.0 * (cost["bytes"] / pk.hbm_bytes_per_s) / measured_s
    fp_pct = 100.0 * (cost["flops"] / pk.fp32_flops) / measured_s
    top = max(bw_pct, fp_pct)
    if top < 15.0:
        bound = "latency/overhead"
    elif top == bw_pct:
        bound = "hbm-bandwidth"
    else:
        bound = "fp32-compute"
    return {
        "model_gb": round(cost["bytes"] / 1e9, 4),
        "model_gflop": round(cost["flops"] / 1e9, 2),
        "hbm_roofline_pct": round(bw_pct, 1),
        "fp32_roofline_pct": round(fp_pct, 1),
        "bound": bound,
    }
