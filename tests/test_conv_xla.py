"""The XLA overlap-save convolution (ops/fft_filter.segmented_fft_conv, the
path every FIR, fused LTI cascade and reverb takes offline) against float64
np.convolve, over kernel lengths, planning units and output delays."""

import numpy as np
import pytest
import jax.numpy as jnp

from pyaudiodsptools_tpu.ops import fft_filter

from ref_loader import snr_db


@pytest.mark.parametrize("shift", [0, 37])
@pytest.mark.parametrize("unit", [256, 500, 512, 4096])
@pytest.mark.parametrize("kernel_len", [1, 2, 63, 255, 513, 1025, 4097, 6145])
def test_segmented_fft_conv_matches_float64(kernel_len, unit, shift):
    rng = np.random.default_rng(kernel_len * 7 + unit + shift)
    k = rng.standard_normal(kernel_len) / np.sqrt(kernel_len)
    spec, halo, seg = fft_filter.pack_segmented_kernel(k, unit)
    assert halo * unit >= kernel_len - 1        # the halo covers the kernel
    x = rng.standard_normal((2, 12, 1000)).astype(np.float32)
    got = np.asarray(fft_filter.segmented_fft_conv(
        spec, jnp.asarray(x), shift, unit, halo, seg))
    assert got.shape == x.shape and got.dtype == np.float32
    flat = x.reshape(2, -1).astype(np.float64)
    want = np.stack([np.concatenate([np.zeros(shift), np.convolve(r, k)])
                     [: flat.shape[1]] for r in flat])
    assert snr_db(want, got.reshape(2, -1)) > 100.0
