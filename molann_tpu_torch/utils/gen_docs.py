"""Generate the port's API reference from its docstrings.

    python -m molann_tpu_torch.utils.gen_docs [--check]

Imports every module of ``molann_tpu_torch`` (not ``__main__``; the CUDA
sources under ``csrc/`` and the build directory ``_build/`` are no
modules), walks its public surface with :mod:`inspect`, and writes one
markdown page per module plus an index into ``molann_tpu_torch/docs/api/``.
The public surface is a module's ``__all__`` where it has one, else its
public names defined there, in source order. ``--check`` generates the
pages into a temporary directory and exits 1 where a committed page
differs from its regenerated bytes, or is missing, or has no module left;
``tests/test_torch_port_docs.py`` runs it. Signatures are made
deterministic: ``id()``s are stripped from default values' reprs, and a
docstring is a class's or function's own (an undocumented method does not
inherit the text of ``torch.nn.Module``'s, which changes with the torch
version). Imports ``torch`` through the package, and no JAX.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
import re
import sys
import tempfile
import textwrap
from pathlib import Path

PACKAGE = "molann_tpu_torch"
TARGET = Path(__file__).resolve().parent.parent / "docs" / "api"
SKIP_MODULES = {f"{PACKAGE}.__main__"}  # argv-driven, no API surface


def _signature(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    sig = re.sub(r" at 0x[0-9a-f]+", "", sig)
    return re.sub(r"<function ([\w.<>]+)>", r"\1", sig)


def _clean_doc(obj) -> str:
    doc = getattr(obj, "__doc__", None)
    return inspect.cleandoc(doc).strip() if isinstance(doc, str) else ""


def _anchor(name: str) -> str:
    return name.lower().replace(".", "").replace("_", "")


def _lineno(obj):
    try:
        return inspect.getsourcelines(obj)[1]
    except (OSError, TypeError):
        return 1 << 30


def _public_members(mod):
    """``__all__`` where the module has one; otherwise its public names
    defined in it; in source order."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")
                 and getattr(getattr(mod, n), "__module__", None)
                 == mod.__name__]
    return sorted(names, key=lambda n: _lineno(getattr(mod, n)))


def _render_function(name, fn) -> list[str]:
    out = [f"### `{name}{_signature(fn)}`", ""]
    doc = _clean_doc(fn)
    return out + ([doc, ""] if doc else [])


def _render_class(name, cls) -> list[str]:
    out = [f"### class `{name}{_signature(cls)}`", ""]
    doc = _clean_doc(cls)
    if doc:
        out += [doc, ""]
    members = []
    for mname, m in vars(cls).items():
        if mname.startswith("_"):
            continue
        if isinstance(m, (staticmethod, classmethod)):
            members.append((mname, m.__func__, "method"))
        elif inspect.isfunction(m):
            members.append((mname, m, "method"))
        elif isinstance(m, property):
            members.append((mname, m, "property"))

    def lineno(entry):
        return _lineno(entry[1].fget if entry[2] == "property" else entry[1])

    for mname, m, kind in sorted(members, key=lineno):
        if kind == "property":
            out += [f"#### property `{name}.{mname}`", ""]
            doc = _clean_doc(m.fget) if m.fget else ""
        else:
            out += [f"#### `{name}.{mname}{_signature(m)}`", ""]
            doc = _clean_doc(m)
        if doc:
            out += [doc, ""]
    return out


def render_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", ""]
    mdoc = _clean_doc(mod)
    if mdoc:
        lines += [mdoc, ""]
    own, reexport = [], []
    for n in _public_members(mod):
        obj = getattr(mod, n, None)
        if obj is None:
            continue
        home = getattr(obj, "__module__", modname)
        (own if home == modname else reexport).append((n, obj, home))
    if reexport and not own:
        lines += ["Public surface (re-exported; follow the links for the "
                  "full documentation):", ""]
        for n, _, home in reexport:
            lines.append(f"- [`{n}`]({home.replace('.', '_')}.md"
                         f"#{_anchor('class ' + n)}) — from `{home}`")
        lines.append("")
    elif reexport:
        lines += ["Re-exported: " + ", ".join(
            f"[`{n}`]({home.replace('.', '_')}.md)"
            for n, _, home in reexport), ""]
    for n, obj, _ in own:
        if inspect.isclass(obj):
            lines += _render_class(n, obj)
        elif callable(obj):
            lines += _render_function(n, obj)
        else:  # a module-level constant
            r = re.sub(r" at 0x[0-9a-f]+", "", repr(obj))
            if len(r) > 300:
                r = r[:297] + "..."
            lines += [f"### `{n}`", "", f"`{n} = {r}`", ""]
    return "\n".join(lines).rstrip() + "\n"


def module_names() -> list[str]:
    """The package and every module under it, but ``__main__``, sorted."""
    pkg = importlib.import_module(PACKAGE)
    return [PACKAGE] + sorted(
        m.name for m in pkgutil.walk_packages(pkg.__path__, PACKAGE + ".")
        if m.name not in SKIP_MODULES)


def generate(out_dir: Path) -> dict[str, str]:
    """Write every page into ``out_dir``; ``{file name: text}``."""
    names = module_names()
    pages = {n.replace(".", "_") + ".md": render_module(n) for n in names}
    idx = [f"# {PACKAGE} API reference", "",
           "Generated from docstrings by `python -m "
           f"{PACKAGE}.utils.gen_docs`; regenerate after changing a public "
           "docstring or signature (`tests/test_torch_port_docs.py` fails "
           "while these pages are stale). The hand-written overview is "
           "[`../api.md`](../api.md), the walkthrough "
           "[`../quickstart.md`](../quickstart.md).", ""]
    for n in names:
        doc = _clean_doc(importlib.import_module(n))
        first = textwrap.shorten(doc.split("\n")[0], 86) if doc else ""
        idx.append(f"{'  ' * n.count('.')}- [`{n}`]({n.replace('.', '_')}.md)"
                   f" — {first}")
    pages["index.md"] = "\n".join(idx) + "\n"
    out_dir.mkdir(parents=True, exist_ok=True)
    for fname, text in pages.items():
        (out_dir / fname).write_text(text)
    return pages


def main(argv) -> int:
    if "--check" in argv:
        with tempfile.TemporaryDirectory() as d:
            fresh = generate(Path(d))
        stale = [f for f, text in fresh.items()
                 if not (TARGET / f).exists()
                 or (TARGET / f).read_text() != text]
        extra = sorted({p.name for p in TARGET.glob("*.md")} - set(fresh))
        if stale or extra:
            print("stale API pages: " + ", ".join(sorted(stale) + extra))
            print(f"run: python -m {PACKAGE}.utils.gen_docs")
            return 1
        print(f"API pages current ({len(fresh)} pages)")
        return 0
    pages = generate(TARGET)
    print(f"wrote {len(pages)} pages to {PACKAGE}/docs/api")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
