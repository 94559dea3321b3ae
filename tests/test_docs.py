"""Docs pipeline: api.md is a BUILD PRODUCT, not a frozen snapshot.

Regenerates the API reference from the live package and asserts the
committed docs/api.md matches — any signature/docstring drift fails CI until
``make -C docs api`` is rerun. Also checks package coverage of the docs
pipeline (gen_api.py + gen_html.py, PARITY.md #31)."""

import re
import subprocess
import sys
from pathlib import Path

DOCS = Path(__file__).resolve().parent.parent / "docs"


def test_api_md_is_fresh(tmp_path):
    committed = (DOCS / "api.md").read_text()
    r = subprocess.run(
        [sys.executable, str(DOCS / "gen_api.py")],
        cwd=str(tmp_path), capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(DOCS.parent)})
    assert r.returncode == 0, r.stdout + r.stderr
    regenerated = (DOCS / "api.md").read_text()
    assert regenerated == committed, (
        "docs/api.md is stale — run `make -C docs api` and commit the result")


def test_gen_api_covers_package():
    """Every module gen_api.py documents must import, and every package
    module with public API must be documented (the docs pipeline is
    gen_api.py + gen_html.py — see PARITY.md #31)."""
    import importlib
    import pkgutil

    import pyaudiodsptools_tpu as pkg

    sys.path.insert(0, str(DOCS))
    try:
        import gen_api
    finally:
        sys.path.pop(0)
    documented = {m for m, _ in gen_api.MODULES}
    for modname in documented:
        importlib.import_module(modname)
    missing = []
    for mod in pkgutil.walk_packages(pkg.__path__, "pyaudiodsptools_tpu."):
        name = mod.name
        if name.endswith("__main__") or ".native" in name:
            continue
        # covered if the module, a parent package, or (for packages) any
        # child module is documented
        parts = name.split(".")
        covered = (any(".".join(parts[:i]) in documented
                       for i in range(2, len(parts) + 1))
                   or any(d.startswith(name + ".") for d in documented))
        if not covered:
            missing.append(name)
    assert not missing, f"undocumented modules: {missing}"


def test_html_fallback_builds():
    """The dependency-free HTML site (docs/gen_html.py — the executable
    docs build for sphinx-less environments) renders every page and the
    output is well-formed enough to serve: one <html> per page, balanced
    code fences, and the api reference's module headings present."""
    r = subprocess.run(
        [sys.executable, str(DOCS / "gen_html.py")],
        capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(DOCS.parent)})
    assert r.returncode == 0, r.stdout + r.stderr
    out = DOCS / "_build" / "html"
    pages = sorted(p.name for p in out.glob("*.html"))
    assert "index.html" in pages and "api.html" in pages, pages
    api = (out / "api.html").read_text()
    assert api.count("<html") == 1
    assert "<h2>" in api
    assert "pyaudiodsptools_tpu.ops.fft_filter" in api
    arch = (out / "architecture.html").read_text()
    assert "<pre><code>" in arch  # code fences survive the renderer
    index = (out / "index.html").read_text()
    assert 'href="api.html"' in index
