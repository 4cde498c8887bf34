"""The port stands alone: no JAX, no PyYAML, nothing of ``ofdmgan_tpu``, and
no Pillow or matplotlib at import time (the GPU's machine has neither;
``load_image`` imports Pillow when called, the plots matplotlib).

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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "matplotlib",
             "ofdmgan_tpu")
# each imported inside a function of one module (None: of any module), where
# it is needed, and never at module level
IN_FUNCTIONS_ONLY = {"yaml": "ofdmgan_tpu_torch/config.py",
                     "PIL": "ofdmgan_tpu_torch/signal/image_ofdm.py",
                     "matplotlib": None}
MODULES = ("ofdmgan_tpu_torch.signal.channel", "ofdmgan_tpu_torch.signal.image_ofdm",
           "ofdmgan_tpu_torch.signal.qam", "ofdmgan_tpu_torch.signal.ofdm",
           "ofdmgan_tpu_torch.training.trainer", "ofdmgan_tpu_torch.train",
           "ofdmgan_tpu_torch.quant.qformat", "ofdmgan_tpu_torch.quant.fakequant",
           "ofdmgan_tpu_torch.quant.export", "ofdmgan_tpu_torch.quant.intsim",
           "ofdmgan_tpu_torch.quant.rom_codegen", "ofdmgan_tpu_torch.verify.cosim",
           "ofdmgan_tpu_torch.export", "ofdmgan_tpu_torch.export_mini_weights",
           "ofdmgan_tpu_torch.eval.metrics", "ofdmgan_tpu_torch.eval.equalizers",
           "ofdmgan_tpu_torch.eval.benchmark", "ofdmgan_tpu_torch.eval.ber",
           "ofdmgan_tpu_torch.eval.distributional", "ofdmgan_tpu_torch.eval.loading",
           "ofdmgan_tpu_torch.benchmark_comparison", "ofdmgan_tpu_torch.enhance",
           "ofdmgan_tpu_torch.eval_checkpoint", "ofdmgan_tpu_torch.distributional_report",
           "ofdmgan_tpu_torch.verify.golden", "ofdmgan_tpu_torch.verify.arch_check",
           "ofdmgan_tpu_torch.verify.proof", "ofdmgan_tpu_torch.verify.cosim_report",
           "ofdmgan_tpu_torch.verify.vcd", "ofdmgan_tpu_torch.verify.rtl_cycle_model",
           "ofdmgan_tpu_torch.make_rtl_handoff", "ofdmgan_tpu_torch.vcd_crosscheck",
           "ofdmgan_tpu_torch.simplegan", "ofdmgan_tpu_torch.simplegan.model",
           "ofdmgan_tpu_torch.simplegan.export", "ofdmgan_tpu_torch.simplegan.train_cli",
           "ofdmgan_tpu_torch.selfcheck", "ofdmgan_tpu_torch.ops.bf16_dots",
           "ofdmgan_tpu_torch.export_serving", "ofdmgan_tpu_torch.bench_infer",
           "ofdmgan_tpu_torch.viz", "ofdmgan_tpu_torch.viz.signal_viz",
           "ofdmgan_tpu_torch.viz.image_transmission", "ofdmgan_tpu_torch.viz.diagrams",
           "ofdmgan_tpu_torch.distributional_figure", "ofdmgan_tpu_torch.cross_channel_matrix",
           "ofdmgan_tpu_torch.utils.torch_port", "ofdmgan_tpu_torch.model_selftest",
           "ofdmgan_tpu_torch.parallel", "ofdmgan_tpu_torch.parallel.mesh",
           "ofdmgan_tpu_torch.parallel.distributed", "ofdmgan_tpu_torch.parallel.gspmd",
           "ofdmgan_tpu_torch.parallel.pipeline", "ofdmgan_tpu_torch.dryrun",
           "ofdmgan_tpu_torch.models.flat", "ofdmgan_tpu_torch.training.chunks",
           "ofdmgan_tpu_torch.training.schedules", "ofdmgan_tpu_torch.signal.datagen")

IMPORT_ALL = f"""
import sys
for name in {FORBIDDEN!r} + ("orbax.checkpoint",):
    sys.modules[name] = None
import importlib, pkgutil
import ofdmgan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ofdmgan_tpu_torch.__path__, "ofdmgan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
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
    lines = out.stdout.strip().splitlines()
    assert int(lines[-1]) >= 64
    assert set(MODULES) <= set(lines[-2].split())


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_nothing_forbidden(path):
    # PyYAML (config.load_config), Pillow (image_ofdm.load_image) and
    # matplotlib (the plots) may be imported inside a function of their
    # modules but never at module level; the rest nowhere
    assert not set(_imports(path, False)) & (set(FORBIDDEN) - set(IN_FUNCTIONS_ONLY))
    for name, home in IN_FUNCTIONS_ONLY.items():
        assert name not in set(_imports(path, home is None or path == REPO / home))


@pytest.mark.parametrize("name, line", [("PIL", "from PIL import Image"),
                                        ("matplotlib", "import matplotlib.pyplot as plt")])
def test_a_module_level_pillow_import_fails_the_check(tmp_path, name, line):
    src = tmp_path / "mod.py"
    src.write_text(f"import numpy\n{line}\n")
    assert name in set(_imports(src, True))
    src.write_text(f"def load():\n    {line}\n    return 0\n")
    assert name not in set(_imports(src, True)) and name in set(_imports(src, False))


def test_entry_points_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from ofdmgan_tpu_torch import (bench_infer, cross_channel_matrix, distributional_figure,
                                   dryrun, export_serving, make_rtl_handoff, model_selftest,
                                   selfcheck, vcd_crosscheck)
    from ofdmgan_tpu_torch import train as train_cli
    from ofdmgan_tpu_torch.device import resolve_device
    from ofdmgan_tpu_torch.simplegan import train_cli as simplegan_cli
    from ofdmgan_tpu_torch.training.trainer import Trainer
    from ofdmgan_tpu_torch.verify import arch_check, cosim_report

    out = str(tmp_path)
    for call in (resolve_device, Trainer,
                 lambda: train_cli.main(["--checkpoint_dir", out]),
                 lambda: train_cli.main(["--checkpoint_dir", out, "--dp", "2"]),
                 lambda: train_cli.main(["--checkpoint_dir", out, "--strategy", "gspmd",
                                         "--model", "full", "--tp", "2"]),
                 dryrun.entry,
                 lambda: make_rtl_handoff.main(["--out_dir", out, "--rom_file", f"{out}/r.v"]),
                 lambda: simplegan_cli.main(["--steps", "2", "--output_dir", out]),
                 lambda: selfcheck.main([]),
                 lambda: vcd_crosscheck.main(["--rtl_dir", out]),
                 lambda: arch_check.run_full_verification(output_dir=out),
                 lambda: cosim_report.run_cosim_verification(output_dir=out),
                 lambda: export_serving.main(["--checkpoint", f"{out}/g.npz", "--out", out]),
                 lambda: bench_infer.main([]), lambda: model_selftest.main([]),
                 lambda: cross_channel_matrix.main(["--out", f"{out}/m.json"]),
                 lambda: distributional_figure.main(["--out", f"{out}/f.png"])):
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
