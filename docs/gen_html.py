"""Dependency-free static HTML build of the docs site.

The reference publishes a built docs site (reference docs/conf.py,
README.md:7 readthedocs). This generator is the framework's counterpart
and the BUILD OF RECORD (PARITY.md #31): it renders every docs/*.md page
(api.md, architecture.md, migration.md) plus an index into
``docs/_build/html/`` using only the stdlib — headings, code fences, inline
code, tables, lists, links, emphasis. tests/test_docs.py executes this
generator and checks the site is well-formed.

Usage: python docs/gen_html.py  (or ``make -C docs html``)
"""

from __future__ import annotations

import html
import os
import re

DOCS = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(DOCS, "_build", "html")

PAGES = [
    ("architecture.md", "Architecture"),
    ("migration.md", "Migration from pyAudioDspTools"),
    ("api.md", "API reference"),
]

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       max-width: 56rem; margin: 2rem auto; padding: 0 1rem;
       color: #1a1a1a; line-height: 1.55; }
code { background: #f2f2f4; padding: .1em .3em; border-radius: 3px;
       font-size: .92em; }
pre { background: #f6f6f8; border: 1px solid #e2e2e6; border-radius: 6px;
      padding: .8rem; overflow-x: auto; }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; margin: 1rem 0; }
th, td { border: 1px solid #d4d4da; padding: .35rem .6rem;
         text-align: left; }
th { background: #f2f2f4; }
h1, h2, h3 { line-height: 1.25; }
h2 { border-bottom: 1px solid #e2e2e6; padding-bottom: .25rem; }
nav a { margin-right: 1rem; }
a { color: #0b57d0; text-decoration: none; }
a:hover { text-decoration: underline; }
"""


def _inline(text: str) -> str:
    text = html.escape(text, quote=False)
    text = re.sub(r"`([^`]+)`", r"<code>\1</code>", text)
    text = re.sub(r"\[([^\]]+)\]\(([^)\s]+)\)", r'<a href="\2">\1</a>', text)
    text = re.sub(r"\*\*([^*]+)\*\*", r"<strong>\1</strong>", text)
    text = re.sub(r"(?<![\w*])\*([^*\n]+)\*(?![\w*])", r"<em>\1</em>", text)
    return text


def md_to_html(md: str) -> str:
    out: list[str] = []
    lines = md.split("\n")
    i = 0
    in_list = False

    def close_list():
        nonlocal in_list
        if in_list:
            out.append("</ul>")
            in_list = False

    while i < len(lines):
        line = lines[i]
        if line.startswith("```"):
            close_list()
            block: list[str] = []
            i += 1
            while i < len(lines) and not lines[i].startswith("```"):
                block.append(lines[i])
                i += 1
            out.append("<pre><code>"
                       + html.escape("\n".join(block)) + "</code></pre>")
            i += 1
            continue
        m = re.match(r"^(#{1,6})\s+(.*)$", line)
        if m:
            close_list()
            lvl = len(m.group(1))
            out.append(f"<h{lvl}>{_inline(m.group(2))}</h{lvl}>")
            i += 1
            continue
        if line.startswith("|") and i + 1 < len(lines) \
                and re.match(r"^\|[\s:|-]+\|?\s*$", lines[i + 1]):
            close_list()
            cells = [c.strip() for c in line.strip("|").split("|")]
            out.append("<table><tr>"
                       + "".join(f"<th>{_inline(c)}</th>" for c in cells)
                       + "</tr>")
            i += 2
            while i < len(lines) and lines[i].startswith("|"):
                cells = [c.strip() for c in lines[i].strip("|").split("|")]
                out.append("<tr>"
                           + "".join(f"<td>{_inline(c)}</td>" for c in cells)
                           + "</tr>")
                i += 1
            out.append("</table>")
            continue
        m = re.match(r"^\s*[-*]\s+(.*)$", line)
        if m:
            if not in_list:
                out.append("<ul>")
                in_list = True
            out.append(f"<li>{_inline(m.group(1))}</li>")
            i += 1
            continue
        if not line.strip():
            close_list()
            i += 1
            continue
        para = [line]
        while i + 1 < len(lines) and lines[i + 1].strip() \
                and not re.match(r"^(#|```|\||\s*[-*]\s)", lines[i + 1]):
            i += 1
            para.append(lines[i])
        close_list()
        out.append(f"<p>{_inline(' '.join(para))}</p>")
        i += 1
    close_list()
    return "\n".join(out)


def _page(title: str, body: str, nav: str) -> str:
    return (f"<!DOCTYPE html>\n<html lang=\"en\"><head>"
            f"<meta charset=\"utf-8\">"
            f"<meta name=\"viewport\" content=\"width=device-width\">"
            f"<title>{html.escape(title)} — pyaudiodsptools_tpu</title>"
            f"<style>{_CSS}</style></head><body>"
            f"<nav>{nav}</nav>\n{body}\n</body></html>\n")


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    pages = [(src, title) for src, title in PAGES
             if os.path.exists(os.path.join(DOCS, src))]
    nav = "".join(
        f'<a href="{os.path.splitext(src)[0]}.html">{html.escape(t)}</a>'
        for src, t in [("index.md", "Home")] + pages)
    index_body = ["<h1>pyaudiodsptools_tpu</h1>",
                  "<p>An accelerator-native audio-effects framework with "
                  "the full pyAudioDspTools feature set: functional effects "
                  "over <code>(params, state, block)</code>, jit-compiled "
                  "chains, a Pallas kernel for the dynamics automaton, and "
                  "a <code>jax.sharding</code> multi-device layer.</p>",
                  "<ul>"]
    for src, title in pages:
        dst = os.path.splitext(src)[0] + ".html"
        with open(os.path.join(DOCS, src)) as f:
            body = md_to_html(f.read())
        with open(os.path.join(OUT, dst), "w") as f:
            f.write(_page(title, body, nav))
        index_body.append(f'<li><a href="{dst}">{html.escape(title)}</a></li>')
    index_body.append("</ul>")
    with open(os.path.join(OUT, "index.html"), "w") as f:
        f.write(_page("Home", "\n".join(index_body), nav))
    print(f"wrote {OUT} ({len(pages) + 1} pages)")


if __name__ == "__main__":
    main()
