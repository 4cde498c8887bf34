"""The port stands alone: no JAX, no PyYAML, nothing of ``ofdmgan_tpu``.

Every module of ``ofdmgan_tpu_torch`` is imported in a fresh interpreter in
which those modules cannot be imported, and the sources and
``chip_smoke.py`` are read for imports. Entry points run on the GPU unless
told otherwise, so without one they raise.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "ofdmgan_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "ofdmgan_tpu")

IMPORT_ALL = f"""
import sys
for name in {FORBIDDEN!r} + ("orbax.checkpoint",):
    sys.modules[name] = None
import importlib, pkgutil
import ofdmgan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ofdmgan_tpu_torch.__path__, "ofdmgan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def _imports(path: Path, module_level_only: bool):
    tree = ast.parse(path.read_text(), filename=str(path))
    nodes = tree.body if module_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_every_module_imports_without_jax_yaml_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_nothing_forbidden(path):
    # PyYAML may be imported inside a function (config.load_config) but never
    # at module level; the rest nowhere
    assert not set(_imports(path, False)) & (set(FORBIDDEN) - {"yaml"})
    assert "yaml" not in set(_imports(path, path.name == "config.py"))


def test_entry_points_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from ofdmgan_tpu_torch import train as train_cli
    from ofdmgan_tpu_torch.device import resolve_device
    from ofdmgan_tpu_torch.training.trainer import Trainer

    for call in (resolve_device, Trainer,
                 lambda: train_cli.main(["--checkpoint_dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_chip_smoke_fails_without_a_gpu_or_without_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (REPO, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_the_port_is_not_gitignored():
    if shutil.which("git") is None or subprocess.run(
            ["git", "rev-parse", "--is-inside-work-tree"], cwd=REPO,
            capture_output=True).returncode != 0:
        pytest.skip("not a git checkout")
    paths = [str(p.relative_to(REPO)) for p in sorted(PACKAGE.rglob("*"))
             if p.is_file() and "__pycache__" not in p.parts]
    paths += ["chip_smoke.py"] + [f"tests/{p.name}" for p in (REPO / "tests").glob("test_torch_*.py")]
    out = subprocess.run(["git", "check-ignore", "--no-index", *paths], cwd=REPO,
                         capture_output=True, text=True)
    assert out.stdout.strip() == "", out.stdout
