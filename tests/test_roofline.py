"""Roofline cost models (pyaudiodsptools_tpu/roofline.py): sanity checks on
the modeled bytes/flops and the bound classifier used by bench_ops."""

import math

import pytest

from pyaudiodsptools_tpu import roofline as rl


def test_peaks_lookup():
    pk = rl.peaks_for("NVIDIA H100 80GB HBM3")
    assert pk.tensor_bf16_flops == 989e12 and pk.hbm_bytes_per_s == 3.35e12
    assert pk.fp32_flops == 67e12
    with pytest.raises(ValueError, match="no published peaks"):
        rl.peaks_for("unknown accelerator")


def test_conv_cost_scales():
    base = rl.conv_cost(C=64, T=1_323_008, block_size=512, halo=16, seg=48)
    dbl = rl.conv_cost(C=128, T=1_323_008, block_size=512, halo=16, seg=48)
    assert abs(dbl["flops"] / base["flops"] - 2.0) < 1e-9
    assert abs(dbl["bytes"] / base["bytes"] - 2.0) < 1e-9
    # windows overlap by (halo+seg)/seg: 64/48 of the signal read + 1 write
    n_windows = 64 * -(-1_323_008 // (48 * 512))
    assert base["bytes"] == 4.0 * (n_windows * 64 * 512 + 64 * 1_323_008)
    n = 64 * 512
    assert base["flops"] == n_windows * (5.0 * n * math.log2(n) + 3.0 * n)


def test_conv_cost_from_params_reads_fir_geometry():
    from pyaudiodsptools_tpu import EngineConfig, ops

    cfg = EngineConfig(44100, 4096)
    eff = ops.lowcut(cfg, 200.0)
    cost = rl.conv_cost_from_params(64, 44100 * 30, eff.params)
    assert cost is not None and cost["flops"] > 0 and cost["bytes"] > 0
    assert rl.conv_cost_from_params(64, 1000, ops.tremolo(cfg).params) is None


def test_classify_names_the_binding_resource():
    pk = rl.Peaks(tensor_bf16_flops=1000.0, fp32_flops=100.0,
                  hbm_bytes_per_s=100.0)
    # 1 second measured, 90 units of bytes -> 90% bandwidth roofline
    r = rl.classify(1.0, {"bytes": 90.0, "flops": 5.0}, pk)
    assert r["bound"] == "hbm-bandwidth" and r["hbm_roofline_pct"] == 90.0
    r = rl.classify(1.0, {"bytes": 5.0, "flops": 80.0}, pk)
    assert r["bound"] == "fp32-compute" and r["fp32_roofline_pct"] == 80.0
    r = rl.classify(1.0, {"bytes": 1.0, "flops": 1.0}, pk)
    assert r["bound"] == "latency/overhead"
