"""Offline stereo render — the reference's Example2.py.

The reference processes stereo as two per-channel device instances in an
interleaved Python loop (Example2.py:13-23). Here channels are just a leading
batch axis: the same chain renders (2, n) audio in one program. The input
wav is generated; files go to the directory given as the first argument, or
the system temp directory.
"""

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

out_dir = _sys.argv[1] if len(_sys.argv) > 1 else tempfile.gettempdir()
in_path = _os.path.join(out_dir, "input_stereo.wav")
out_path = _os.path.join(out_dir, "output_stereo.wav")
wavio.write_wav(in_path, generators.demo_signal(6 * 44100, 44100, 2), 44100)

cfg = EngineConfig(sample_rate=44100, block_size=4096)
chain = Chain([ops.lowcut(cfg, 800)])

audio, _ = wavio.read_wav(in_path)  # (2, n)
out = np.asarray(render(chain, audio, cfg))
wavio.write_wav(out_path, out, cfg.sample_rate)
print("wrote", out_path, out.shape)
