"""What the benchmark's files import, read from their source: the plain
reference imports nothing of JAX, of the JAX package or of the port, and
nothing outside itself in the benchmark; no file of the benchmark imports
JAX or the JAX package. Top-level names are compared whole: the port's
``ofdmgan_tpu_torch`` begins with the JAX package's ``ofdmgan_tpu``."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "ofdmgan_tpu"}
PORT = "ofdmgan_tpu_torch"


def imported(path: Path):
    """(top-level name, relative level) of every import in the file."""
    return imported_by(path.read_text())


def imported_by(source: str):
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".")[0], node.level))
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    names = {name for name, level in imported(path) if level == 0}
    assert not names & JAX, names & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port_or_the_benchmark(path):
    for name, level in imported(path):
        assert level <= 1, f"{path.name} imports from outside reference/"
        if level == 0:
            assert name not in JAX | {PORT, "perfbench"}, name


def test_names_are_compared_whole():
    src = "import ofdmgan_tpu_torch.training\nfrom ofdmgan_tpu_torch import ops\n"
    names = {name for name, _ in imported_by(src)}
    assert names == {PORT} and not names & JAX


def test_the_runs_module_check_compares_whole_names(monkeypatch):
    import sys

    from perfbench import run
    monkeypatch.setitem(sys.modules, "ofdmgan_tpu_torch_like", object())
    assert "ofdmgan_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()
