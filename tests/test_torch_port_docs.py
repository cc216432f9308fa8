"""The port's walkthrough and API reference, held as the JAX package's docs
are held (``tests/test_docs.py``).

Every ```python block of ``molann_tpu_torch/docs/quickstart.md`` runs
verbatim in one namespace in a temporary directory on the CPU, the one
line that names the card changed to the host; the walkthrough trains a
model whose loss falls and writes ``model.npz`` and its engine artifact.
``molann_tpu_torch/docs/api.md`` names every name of the package's
``__all__`` and of its subpackages'. The generated pages under
``molann_tpu_torch/docs/api/`` are what ``python -m
molann_tpu_torch.utils.gen_docs`` writes. Neither the walkthrough nor the
generator imports JAX or the JAX package.
"""

import importlib
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
DOCS = REPO / "molann_tpu_torch" / "docs"
DEVICE_LINE = 'device = torch.device("cuda")'
SUBPACKAGES = ("ops", "parallel", "train", "io", "sampling", "utils",
               "serve", "systems", "pbc")
# an import of JAX or of the JAX package (``molann_tpu`` but not
# ``molann_tpu_torch``), at the start of a line
JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|molann_tpu(?!_torch))\b", re.MULTILINE)


def _python_blocks(md_path):
    return re.findall(r"```python\n(.*?)```", md_path.read_text(),
                      flags=re.DOTALL)


def test_quickstart_blocks_execute(tmp_path, monkeypatch):
    """The walkthrough runs block by block on the host and does what the
    JAX walkthrough's test asserts: a model trains with falling loss, and
    ``model.npz`` and the artifact (``model.pt``) are written."""
    blocks = _python_blocks(DOCS / "quickstart.md")
    assert len(blocks) >= 13, "the walkthrough lost its code blocks"
    assert sum(b.count(DEVICE_LINE) for b in blocks) == 1
    assert not [b for b in blocks if JAX_IMPORT.search(b)]
    monkeypatch.chdir(tmp_path)
    ns = {}
    for i, block in enumerate(blocks):
        block = block.replace(DEVICE_LINE, 'device = torch.device("cpu")')
        try:
            exec(compile(block, f"quickstart.md[block {i}]", "exec"), ns)
        except Exception as e:
            raise AssertionError(
                f"quickstart.md block {i} failed: {e}\n---\n{block}") from e
    assert "model" in ns and "result" in ns
    assert ns["result"].losses[-1] < ns["result"].losses[0]
    assert (tmp_path / "model.npz").exists()
    assert (tmp_path / "model.pt").exists()


@pytest.mark.parametrize("package", ("", *SUBPACKAGES))
def test_api_doc_mentions_public_surface(package):
    """``docs/api.md`` names every name of the ``__all__`` of the package
    and of each subpackage (or module) it maps."""
    name = "molann_tpu_torch" + (f".{package}" if package else "")
    api = (DOCS / "api.md").read_text()
    assert f"## {name}" in api or not package
    missing = [n for n in importlib.import_module(name).__all__
               if f"`{n}" not in api]
    assert not missing, f"api.md lacks {name}'s {missing}"


def test_api_reference_current():
    """The generated pages are current: ``gen_docs --check`` regenerates
    them and finds the committed bytes. Fails -> run ``python -m
    molann_tpu_torch.utils.gen_docs``."""
    proc = subprocess.run(
        [sys.executable, "-m", "molann_tpu_torch.utils.gen_docs", "--check"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (DOCS / "api" / "index.md").exists()


def test_docs_modules_import_no_jax():
    """The generator and the walkthrough import neither JAX nor the JAX
    package (the generator keeps its own copy of what it shares with
    ``scripts/gen_docs.py``)."""
    sources = {
        "gen_docs.py": (REPO / "molann_tpu_torch" / "utils"
                        / "gen_docs.py").read_text(),
        "quickstart.md": "\n".join(_python_blocks(DOCS / "quickstart.md")),
    }
    for name, text in sources.items():
        assert not JAX_IMPORT.search(text), name
    code = ("import sys, molann_tpu_torch.utils.gen_docs as g; "
            "g.module_names(); "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m == 'molann_tpu' or m.startswith(('jax.', "
            "'molann_tpu.'))))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
