"""Generate docs/api.md from the package's signatures and docstrings.

The reference publishes a Sphinx autodoc site (reference docs/conf.py uses
autodoc+napoleon over numpydoc docstrings); this is the equivalent without a
Sphinx dependency: ``python docs/gen_api.py`` rewrites ``docs/api.md``.
"""

from __future__ import annotations

import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

MODULES = [
    ("pyaudiodsptools_tpu.core.config", "Engine configuration"),
    ("pyaudiodsptools_tpu.core.block", "Blocking"),
    ("pyaudiodsptools_tpu.core.wavio", "WAV I/O"),
    ("pyaudiodsptools_tpu.core.generators", "Signal generators"),
    ("pyaudiodsptools_tpu.core.utility", "Gain / dither / metering utilities"),
    ("pyaudiodsptools_tpu.core.metering", "Block metering"),
    ("pyaudiodsptools_tpu.ops", "Effect op factories"),
    ("pyaudiodsptools_tpu.ops.base", "Op protocol"),
    ("pyaudiodsptools_tpu.ops.fft_filter", "FIR machinery"),
    ("pyaudiodsptools_tpu.engine.chain", "Chains"),
    ("pyaudiodsptools_tpu.engine.render", "Offline rendering"),
    ("pyaudiodsptools_tpu.engine.stream", "Streaming"),
    ("pyaudiodsptools_tpu.engine.resumable", "Checkpoint / resume"),
    ("pyaudiodsptools_tpu.parallel.mesh", "Mesh building"),
    ("pyaudiodsptools_tpu.parallel.sharding", "Sharded rendering"),
    ("pyaudiodsptools_tpu.parallel.timescan", "Time-sharded recurrences"),
    ("pyaudiodsptools_tpu.parallel.dist", "Multi-host runtime"),
    ("pyaudiodsptools_tpu.parallel.dynspec", "Time-sharded dynamics"),
    ("pyaudiodsptools_tpu.kernels.dynamics_walk", "Dynamics walk kernel"),
    ("pyaudiodsptools_tpu.core.settings", "Settings registry"),
    ("pyaudiodsptools_tpu.runtime.realtime", "Realtime native runtime"),
    ("pyaudiodsptools_tpu.runtime.portaudio", "Audio-device adapter"),
    ("pyaudiodsptools_tpu.core.dfloat", "Double-float arithmetic"),
    ("pyaudiodsptools_tpu.roofline", "Roofline cost models"),
    ("pyaudiodsptools_tpu.profiling", "Profiling"),
    ("pyaudiodsptools_tpu.compat", "pyAudioDspTools compat API"),
]


def first_para(doc: str | None) -> str:
    if not doc:
        return ""
    para = doc.strip().split("\n\n")[0]
    return " ".join(line.strip() for line in para.splitlines())


def sig_of(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def document(modname: str, title: str, out: list[str]) -> None:
    import importlib

    mod = importlib.import_module(modname)
    out.append(f"\n## {title} — `{modname}`\n")
    intro = first_para(mod.__doc__)
    if intro:
        out.append(intro + "\n")
    names = getattr(mod, "__all__", None) or [
        n for n in sorted(dir(mod)) if not n.startswith("_")
    ]
    for name in names:
        obj = getattr(mod, name, None)
        if obj is None or inspect.ismodule(obj):
            continue
        defined_in = getattr(obj, "__module__", modname)
        if not (defined_in or "").startswith("pyaudiodsptools_tpu"):
            continue
        if inspect.isclass(obj):
            out.append(f"### class `{name}{sig_of(obj)}`\n")
            if d := first_para(obj.__doc__):
                out.append(d + "\n")
            for mname, meth in inspect.getmembers(obj, inspect.isfunction):
                if mname.startswith("_"):
                    continue
                out.append(f"- **`.{mname}{sig_of(meth)}`** — "
                           f"{first_para(meth.__doc__)}\n")
        elif callable(obj):
            out.append(f"### `{name}{sig_of(obj)}`\n")
            if d := first_para(obj.__doc__):
                out.append(d + "\n")


def main() -> None:
    out = [
        "# API reference\n",
        "Generated by `python docs/gen_api.py` from signatures and "
        "docstrings. Reference-parity citations (`file:line` into the "
        "upstream pyAudioDspTools sources) live in the full docstrings.\n",
    ]
    for modname, title in MODULES:
        document(modname, title, out)
    path = os.path.join(os.path.dirname(__file__), "api.md")
    with open(path, "w") as f:
        f.write("\n".join(out))
    print(f"wrote {path} ({sum(len(s) for s in out)} chars)")


if __name__ == "__main__":
    main()
