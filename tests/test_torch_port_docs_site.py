"""The port's HTML docs site and its design notes.

``python -m molann_tpu_torch.utils.build_docs_site`` is built into a
temporary directory and checked as ``tests/test_docs.py`` checks the JAX
package's site: one page per markdown file (the README's section on the
port as the index), each well formed with its ``<nav>``, and every
intra-site link resolving. Its ``render_markdown`` is the port's own copy
of ``scripts/build_docs_site.py``'s and must give that renderer's HTML on
every page and on snippets of each construct. Every repository path that
``molann_tpu_torch/docs/design.md`` cites in backticks must exist.
"""

import html.parser
import re
import sys
from pathlib import Path

import pytest

from molann_tpu_torch.utils import build_docs_site as site

REPO = Path(__file__).resolve().parents[1]
DOCS = REPO / "molann_tpu_torch" / "docs"
MARKDOWN = sorted(DOCS.glob("*.md")) + sorted((DOCS / "api").glob("*.md"))


@pytest.fixture(scope="module")
def jax_renderer():
    """``scripts/build_docs_site.py``'s ``render_markdown`` (standard
    library only: it imports nothing of JAX)."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import build_docs_site
    finally:
        sys.path.pop(0)
    return build_docs_site.render_markdown


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    out = tmp_path_factory.mktemp("site")
    return out, site.build_site(str(out))


class _Checker(html.parser.HTMLParser):
    VOID = {"br", "hr", "img", "meta", "link", "input"}

    def __init__(self):
        super().__init__()
        self.stack, self.errs = [], []

    def handle_starttag(self, tag, attrs):
        if tag not in self.VOID:
            self.stack.append(tag)

    def handle_endtag(self, tag):
        if self.stack and self.stack[-1] == tag:
            self.stack.pop()
        else:
            self.errs.append(tag)


def test_one_page_per_markdown_file(built):
    out, written = built
    assert written[0] == "index.html" and "api_index.html" in written
    assert {"quickstart.html", "api.html", "design.html"} <= set(written)
    assert len(written) == len(set(written)) == 1 + len(MARKDOWN)
    assert sorted(p.name for p in out.glob("*.html")) == sorted(written)


def test_pages_are_well_formed_with_a_sidebar(built):
    out, written = built
    for name in written:
        text = (out / name).read_text()
        c = _Checker()
        c.feed(text)
        assert not c.errs and not c.stack, (name, c.errs[:3], c.stack[:3])
        assert text.count("<nav>") == 1 and "molann_tpu_torch" in text
        assert f'data-page="{name}" class="current"' in text


def test_intra_site_links_resolve(built):
    """Every ``href`` to a page of the site resolves; ``.md`` links to the
    site's pages were rewritten to ``.html``; links to files of the
    repository outside the site are left as they are."""
    out, written = built
    rewritten = 0
    for page in out.glob("*.html"):
        for h in re.findall(r'href="([^"#]+)"', page.read_text()):
            if h.startswith(("http:", "https:", "mailto:")):
                continue
            if h.endswith(".html"):
                assert (out / h).exists(), (page.name, h)
                rewritten += 1
    assert rewritten > len(written)  # the sidebar alone links every page
    index = (out / "index.html").read_text()
    assert 'href="quickstart.html"' in index and 'href="api.html"' in index


def test_index_is_the_readme_section_on_the_port(built):
    out, _ = built
    text = (out / "index.html").read_text()
    assert '<h1 id="pytorch-port-on-nvidia-gpus-molann-tpu-torch">' in text
    md = site.readme_section((REPO / "README.md").read_text())
    assert md.startswith("# PyTorch port on NVIDIA GPUs")
    assert "\n## " not in md


@pytest.mark.parametrize("argv", [["{}"], ["--out", "{}"]])
def test_main_writes_the_site_where_asked(tmp_path, capsys, argv):
    out = tmp_path / "site"
    assert site.main([a.format(out) for a in argv]) == 0
    assert (out / "index.html").exists() and (out / "design.html").exists()
    assert f"pages to {out}" in capsys.readouterr().out


def test_default_output_is_ignored_and_outside_docs():
    out = Path(site.DEFAULT_OUT).resolve()
    assert REPO / "docs" not in out.parents
    rel = out.relative_to(REPO).as_posix() + "/"
    assert rel in (REPO / ".gitignore").read_text().splitlines()


@pytest.mark.parametrize("page", MARKDOWN, ids=lambda p: p.name)
def test_render_markdown_matches_the_jax_renderer_on_pages(jax_renderer,
                                                           page):
    md = page.read_text()

    def rewrite(t):
        return t.replace(".md", ".html")

    assert site.render_markdown(md) == jax_renderer(md)
    assert site.render_markdown(md, rewrite) == jax_renderer(md, rewrite)


SNIPPETS = {
    "headings": "# Top `code`\n\n## Second *em*\n\n### Third **bold**\n",
    "fenced code": ("text\n\n```python\nx = [1, 2] < 3 & 4\n```\n\n"
                    "```\nplain\n```\n"),
    "table": "| a | `b` |\n|---|:--:|\n| 1 | [x](y.md) |\n| 2 | **z** |\n",
    "nested lists": ("- one\n  - one.a\n  - one.b\n    1. deep\n- two\n"
                     "  continued\n\n1. first\n2. second\n"),
    "links": "[rel](other.md#part), [abs](https://example.org/a_b), "
             "[frag](#top) and `[not](a link)`\n",
    "quote and rule": "> quoted *text*\n> more\n\n---\n\nafter\n",
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_render_markdown_matches_the_jax_renderer_on_snippets(jax_renderer,
                                                              name):
    md = SNIPPETS[name]
    got = site.render_markdown(md, lambda t: "site/" + t)
    assert got == jax_renderer(md, lambda t: "site/" + t)
    assert got.strip()


# a path of the repository in backticks, with an optional :line or
# :first-last (a directory ends with /)
_CITED = re.compile(r"`([\w.-]+(?:/[\w.-]+)*(?:/|\.(?:py|cu|cuh|cpp|h|md|"
                    r"json|toml|txt)))(?::(\d+)(?:-(\d+))?)?`")


def test_design_notes_cite_paths_that_exist():
    """Every path ``design.md`` cites in backticks exists, relative to the
    repository or to ``molann_tpu_torch/``, and a cited line is in its
    file."""
    text = (DOCS / "design.md").read_text()
    cited = _CITED.findall(text)
    assert len(cited) > 30
    for path, first, last in cited:
        roots = [REPO / path, REPO / "molann_tpu_torch" / path]
        found = [p for p in roots if p.exists()]
        assert found, path
        if first:
            n_lines = len(found[0].read_text().splitlines())
            assert int(last or first) <= n_lines, (path, first, last)
