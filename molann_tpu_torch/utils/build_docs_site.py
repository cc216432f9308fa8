"""Render the port's docs as a browsable HTML site.

    python -m molann_tpu_torch.utils.build_docs_site [OUT | --out OUT]

The port's counterpart of ``scripts/build_docs_site.py``, with its own copy
of that script's renderer (a CommonMark subset: headings, fenced code,
inline code, emphasis, links, lists, tables, blockquotes, rules; the
standard library only). It renders every page of ``molann_tpu_torch/docs/``
(the walkthrough ``quickstart.md``, the map ``api.md``, the design notes
``design.md``), the pages ``python -m molann_tpu_torch.utils.gen_docs``
generates into ``molann_tpu_torch/docs/api/``, and an index page from the
README's section on the port, each self-contained (the CSS inlined), with
a sidebar that mirrors the docs tree and ``.md`` links to the site's pages
rewritten to ``.html``. The default output directory,
``molann_tpu_torch/docs/site/``, is not committed; open its
``index.html`` in a browser. ``tests/test_torch_port_docs_site.py`` builds
the site and holds :func:`render_markdown` to the script's.
"""

from __future__ import annotations

import argparse
import html
import os
import re
import sys

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE_DIR)
DOCS = os.path.join(PACKAGE_DIR, "docs")
DEFAULT_OUT = os.path.join(DOCS, "site")
# the README's section on the port: the index page
README_SECTION = "## PyTorch port on NVIDIA GPUs (`molann_tpu_torch`)"

_CSS = """
:root { --fg: #1c1e21; --bg: #ffffff; --accent: #0b5394; --code-bg: #f5f6f7;
        --border: #e3e5e8; --side-bg: #fafbfc; }
@media (prefers-color-scheme: dark) {
  :root { --fg: #e6e6e6; --bg: #16181c; --accent: #6fa8dc;
          --code-bg: #24272e; --border: #33373f; --side-bg: #1b1e24; } }
* { box-sizing: border-box; }
body { margin: 0; color: var(--fg); background: var(--bg);
       font: 15px/1.55 system-ui, -apple-system, "Segoe UI", sans-serif;
       display: flex; min-height: 100vh; }
nav { width: 280px; flex: none; background: var(--side-bg);
      border-right: 1px solid var(--border); padding: 1.2em 1em;
      overflow-y: auto; position: sticky; top: 0; height: 100vh;
      font-size: 13.5px; }
nav .brand { font-weight: 700; font-size: 15px; margin-bottom: .8em;
             display: block; color: var(--fg); text-decoration: none; }
nav a { color: var(--accent); text-decoration: none; display: block;
        padding: .12em 0; overflow: hidden; text-overflow: ellipsis;
        white-space: nowrap; }
nav a:hover { text-decoration: underline; }
nav .section { margin: .9em 0 .25em; font-weight: 600; color: var(--fg);
               text-transform: uppercase; font-size: 11px;
               letter-spacing: .06em; }
nav a.current { font-weight: 700; }
main { flex: 1; min-width: 0; padding: 2em 3em 4em; max-width: 62em; }
h1, h2, h3, h4 { line-height: 1.25; scroll-margin-top: .5em; }
h1 { border-bottom: 2px solid var(--border); padding-bottom: .3em; }
h2 { border-bottom: 1px solid var(--border); padding-bottom: .2em;
     margin-top: 1.6em; }
a { color: var(--accent); }
code { background: var(--code-bg); border-radius: 4px;
       padding: .1em .35em; font: 13px/1.5 ui-monospace, "SF Mono",
       Menlo, Consolas, monospace; }
pre { background: var(--code-bg); border: 1px solid var(--border);
      border-radius: 8px; padding: .9em 1.1em; overflow-x: auto; }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; margin: 1em 0; display: block;
        overflow-x: auto; }
th, td { border: 1px solid var(--border); padding: .35em .7em;
         text-align: left; }
th { background: var(--code-bg); }
blockquote { border-left: 4px solid var(--border); margin: 1em 0;
             padding: .1em 1em; color: color-mix(in srgb, var(--fg) 75%,
             transparent); }
hr { border: none; border-top: 1px solid var(--border); margin: 2em 0; }
img { max-width: 100%; }
@media (max-width: 900px) { body { flex-direction: column; }
  nav { width: 100%; height: auto; position: static; } }
"""


# ---------------------------------------------------------------------------
# Markdown rendering (CommonMark subset sufficient for the docs tree)
# ---------------------------------------------------------------------------

_INLINE_CODE = re.compile(r"``(.+?)``|`([^`]+)`")
_LINK = re.compile(r"\[([^\]]+)\]\(([^)\s]+)\)")
_BOLD = re.compile(r"\*\*(.+?)\*\*")
_ITAL = re.compile(r"(?<![\w*])\*([^*\s][^*]*?)\*(?![\w*])")


def _inline(text: str, link_rewrite) -> str:
    """Inline markdown -> HTML. Code spans are extracted first so
    emphasis/link syntax inside them stays literal."""
    stash: list[str] = []

    def take_code(m):
        body = m.group(1) or m.group(2)
        stash.append(f"<code>{html.escape(body)}</code>")
        return f"\x00{len(stash) - 1}\x00"

    text = _INLINE_CODE.sub(take_code, text)
    text = html.escape(text, quote=False)

    def take_link(m):
        label, target = m.group(1), m.group(2)
        return (f'<a href="{html.escape(link_rewrite(target), quote=True)}">'
                f"{label}</a>")

    text = _LINK.sub(take_link, text)
    text = _BOLD.sub(r"<strong>\1</strong>", text)
    text = _ITAL.sub(r"<em>\1</em>", text)
    return re.sub(r"\x00(\d+)\x00", lambda m: stash[int(m.group(1))], text)


def _slug(text: str) -> str:
    return re.sub(r"[^a-z0-9]+", "-", text.lower()).strip("-")


def render_markdown(md: str, link_rewrite=lambda t: t) -> str:
    """The block-level pass: fences, headings, lists, tables, quotes,
    rules, paragraphs."""
    out: list[str] = []
    lines = md.splitlines()
    i, n = 0, len(lines)
    para: list[str] = []

    def flush_para():
        if para:
            out.append(f"<p>{_inline(' '.join(para), link_rewrite)}</p>")
            para.clear()

    while i < n:
        line = lines[i]
        stripped = line.strip()
        # fenced code
        if stripped.startswith("```"):
            flush_para()
            lang = stripped[3:].strip()
            body = []
            i += 1
            while i < n and not lines[i].strip().startswith("```"):
                body.append(lines[i])
                i += 1
            i += 1  # closing fence
            cls = f' class="language-{html.escape(lang)}"' if lang else ""
            out.append(f"<pre><code{cls}>"
                       f"{html.escape(chr(10).join(body))}</code></pre>")
            continue
        # blank
        if not stripped:
            flush_para()
            i += 1
            continue
        # heading
        m = re.match(r"(#{1,6})\s+(.*)", stripped)
        if m:
            flush_para()
            level = len(m.group(1))
            body = m.group(2).strip()
            out.append(f'<h{level} id="{_slug(re.sub(_INLINE_CODE, lambda c: c.group(1) or c.group(2), body))}">'
                       f"{_inline(body, link_rewrite)}</h{level}>")
            i += 1
            continue
        # horizontal rule
        if re.fullmatch(r"(-{3,}|\*{3,}|_{3,})", stripped):
            flush_para()
            out.append("<hr>")
            i += 1
            continue
        # table (header row + |---| separator)
        if ("|" in stripped and i + 1 < n
                and re.fullmatch(r"\s*\|?[\s:|-]+\|?\s*", lines[i + 1])
                and "-" in lines[i + 1]):
            flush_para()

            def cells(row):
                return [c.strip() for c in row.strip().strip("|").split("|")]

            head = cells(stripped)
            i += 2
            rows = []
            while i < n and "|" in lines[i] and lines[i].strip():
                rows.append(cells(lines[i]))
                i += 1
            out.append("<table><thead><tr>"
                       + "".join(f"<th>{_inline(c, link_rewrite)}</th>"
                                 for c in head)
                       + "</tr></thead><tbody>")
            for r in rows:
                out.append("<tr>" + "".join(
                    f"<td>{_inline(c, link_rewrite)}</td>" for c in r)
                    + "</tr>")
            out.append("</tbody></table>")
            continue
        # blockquote
        if stripped.startswith(">"):
            flush_para()
            body = []
            while i < n and lines[i].strip().startswith(">"):
                body.append(lines[i].strip()[1:].lstrip())
                i += 1
            inner = render_markdown("\n".join(body), link_rewrite)
            out.append(f"<blockquote>{inner}</blockquote>")
            continue
        # lists (with nesting by indentation and lazy continuations)
        m = re.match(r"(\s*)([-*+]|\d+[.)])\s+(.*)", line)
        if m:
            flush_para()
            i = _render_list(lines, i, out, link_rewrite)
            continue
        para.append(stripped)
        i += 1
    flush_para()
    return "\n".join(out)


def _render_list(lines, i, out, link_rewrite):
    """One list block starting at ``lines[i]``; returns the next index."""
    n = len(lines)
    item_re = re.compile(r"(\s*)([-*+]|\d+[.)])\s+(.*)")
    first = item_re.match(lines[i])
    base_indent = len(first.group(1))
    ordered = first.group(2)[0].isdigit()
    out.append("<ol>" if ordered else "<ul>")
    current: list[str] = []
    nested: list[str] = []

    def flush_item():
        if current or nested:
            body = _inline(" ".join(current), link_rewrite)
            out.append(f"<li>{body}{''.join(nested)}</li>")
            current.clear()
            nested.clear()

    while i < n:
        line = lines[i]
        if not line.strip():
            # blank line ends the list unless the next line continues it
            if (i + 1 < n and (item_re.match(lines[i + 1])
                               or lines[i + 1].startswith(" " * (base_indent + 2)))):
                i += 1
                continue
            break
        m = item_re.match(line)
        if m and len(m.group(1)) == base_indent:
            flush_item()
            current.append(m.group(3).strip())
            i += 1
        elif m and len(m.group(1)) > base_indent:
            sub_out: list[str] = []
            i = _render_list(lines, i, sub_out, link_rewrite)
            nested.append("".join(sub_out))
        elif line.startswith(" " * (base_indent + 2)):
            current.append(line.strip())
            i += 1
        else:
            break
    flush_item()
    out.append("</ol>" if ordered else "</ul>")
    return i


# ---------------------------------------------------------------------------
# Site assembly
# ---------------------------------------------------------------------------


def _page_title(md: str, fallback: str) -> str:
    for line in md.splitlines():
        m = re.match(r"#\s+(.*)", line.strip())
        if m:
            return m.group(1).replace("`", "").strip()
    return fallback


def readme_section(text: str) -> str:
    """The README's section on the port, from its heading to the next
    heading of the same level, as a page of its own (``#`` for ``##``)."""
    lines = text.splitlines()
    start = lines.index(README_SECTION)
    end = next((i for i in range(start + 1, len(lines))
                if lines[i].startswith("## ")), len(lines))
    return "\n".join(["#" + lines[start][2:], *lines[start + 1:end]]) + "\n"


def collect_pages():
    """``[(source path, page name, sidebar section)]`` of every page: the
    README's section as ``index.html``, ``docs/*.md`` as guides, then
    ``docs/api/*.md`` (its index first) as the API reference."""
    pages = [(os.path.join(REPO, "README.md"), "index.html", "Overview")]
    for fn in sorted(os.listdir(DOCS)):
        if fn.endswith(".md"):
            pages.append((os.path.join(DOCS, fn),
                          os.path.splitext(fn)[0] + ".html", "Guides"))
    api = os.path.join(DOCS, "api")
    names = sorted((fn for fn in os.listdir(api) if fn.endswith(".md")),
                   key=lambda fn: (fn != "index.md", fn))
    for fn in names:
        out = ("api_index.html" if fn == "index.md"
               else "api_" + os.path.splitext(fn)[0] + ".html")
        pages.append((os.path.join(api, fn), out, "API reference"))
    return pages


def _source(path):
    with open(path) as fh:
        text = fh.read()
    if os.path.normpath(path) == os.path.join(REPO, "README.md"):
        return readme_section(text)
    return text


def _link_rewriter(src_path, name_map):
    src_dir = os.path.dirname(src_path)

    def rewrite(target: str) -> str:
        if re.match(r"^[a-z][a-z0-9+.-]*:", target) or target.startswith("#"):
            return target  # absolute URL or fragment
        path, frag = (target.split("#", 1) + [""])[:2]
        if path.endswith(".md"):
            resolved = os.path.normpath(os.path.join(src_dir, path))
            if resolved in name_map:
                return name_map[resolved] + (f"#{frag}" if frag else "")
        return target

    return rewrite


def build_site(out_dir=DEFAULT_OUT):
    """Write every page into ``out_dir``; returns the page names."""
    pages = collect_pages()
    name_map = {os.path.normpath(src): out for src, out, _ in pages}
    os.makedirs(out_dir, exist_ok=True)
    sources = {out: _source(src) for src, out, _ in pages}
    titles = {out: _page_title(md, os.path.splitext(out)[0])
              for out, md in sources.items()}

    nav_parts = ['<a class="brand" href="index.html">molann_tpu_torch</a>']
    section = None
    for _, out, sec in pages:
        if sec != section:
            nav_parts.append(f'<div class="section">{html.escape(sec)}</div>')
            section = sec
        nav_parts.append(f'<a href="{out}" data-page="{out}">'
                         f"{html.escape(titles[out])}</a>")
    nav_html = "\n".join(nav_parts)

    for src, out, _ in pages:
        body = render_markdown(sources[out], _link_rewriter(src, name_map))
        page_nav = nav_html.replace(
            f'data-page="{out}"', f'data-page="{out}" class="current"')
        doc = (
            "<!DOCTYPE html>\n<html lang=\"en\">\n<head>\n"
            "<meta charset=\"utf-8\">\n"
            "<meta name=\"viewport\" content=\"width=device-width, "
            "initial-scale=1\">\n"
            f"<title>{html.escape(titles[out])} — molann_tpu_torch</title>\n"
            f"<style>{_CSS}</style>\n</head>\n<body>\n"
            f"<nav>\n{page_nav}\n</nav>\n<main>\n{body}\n</main>\n"
            "</body>\n</html>\n"
        )
        with open(os.path.join(out_dir, out), "w") as fh:
            fh.write(doc)
    return [out for _, out, _ in pages]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", help=f"output directory ({DEFAULT_OUT})")
    ap.add_argument("--out", dest="out_flag", metavar="OUT",
                    help="the same, as the JAX package's script takes it")
    args = ap.parse_args(argv)
    out = args.out or args.out_flag or DEFAULT_OUT
    written = build_site(out)
    print(f"wrote {len(written)} pages to {out} "
          f"(open {os.path.join(out, 'index.html')})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
