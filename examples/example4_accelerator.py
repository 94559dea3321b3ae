"""Accelerator offline render — the reference's Example4.py.

The reference's GPU path duplicates its FFT filters into CuPy clones and
copies chunks to the device by hand (Example4.py:5-24) with a large 88200
chunk to amortize dispatch. Under JAX the SAME ops run on whatever backend is
active; device placement and batching are automatic, and the whole
multi-channel render is one compiled program. The input wav is generated;
files go to the directory given as the first argument, or the system temp
directory.
"""

import jax
import numpy as np

import os as _os
import sys as _sys
import tempfile

# allow standalone `python examples/<name>.py` without installing:
# the repo root is the import path when run from a checkout
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

from pyaudiodsptools_tpu import Chain, EngineConfig, ops, render
from pyaudiodsptools_tpu.core import generators, wavio

print("running on:", jax.devices()[0])

out_dir = _sys.argv[1] if len(_sys.argv) > 1 else tempfile.gettempdir()
in_path = _os.path.join(out_dir, "input_accel.wav")
out_path = _os.path.join(out_dir, "output_accel.wav")
wavio.write_wav(in_path, generators.demo_signal(6 * 44100, 44100), 44100)

cfg = EngineConfig(sample_rate=44100, block_size=88200)
chain = Chain([ops.lowcut(cfg, 800)])

audio, _ = wavio.read_wav(in_path)
out = np.asarray(render(chain, audio, cfg))
wavio.write_wav(out_path, out, cfg.sample_rate)
print("wrote", out_path, out.shape)
