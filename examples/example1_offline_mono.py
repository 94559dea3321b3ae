"""Offline mono render — the reference's Example1.py.

Reference flow (Example1.py:1-23): initialize config, read wav, MakeChunks,
per-chunk LowCut(800).apply loop, CombineChunks, write wav. Here the whole
render is one jit-compiled program. The input wav is generated (6 s of
core.generators.demo_signal); files go to the directory given as the first
argument, or the system temp directory.

    python examples/example1_offline_mono.py [out_dir]
"""

import os as _os
import sys as _sys
import tempfile

# allow standalone `python examples/<name>.py` without installing:
# the repo root is the import path when run from a checkout
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

from pyaudiodsptools_tpu import Chain, EngineConfig, ops, render_file
from pyaudiodsptools_tpu.core import generators, wavio

out_dir = _sys.argv[1] if len(_sys.argv) > 1 else tempfile.gettempdir()
in_path = _os.path.join(out_dir, "input_mono.wav")
out_path = _os.path.join(out_dir, "output_mono.wav")
wavio.write_wav(in_path, generators.demo_signal(6 * 44100, 44100), 44100)

cfg = EngineConfig(sample_rate=44100, block_size=4096)
chain = Chain([ops.lowcut(cfg, 800)])

render_file(chain, in_path, out_path, cfg)
print("wrote", out_path)
