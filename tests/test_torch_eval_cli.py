"""The port's evaluation CLIs on the CPU (``--device cpu``) at small sizes,
against the JAX package's scripts and models.

* ``enhance``: on the committed nonlinear residual champion (a flat
  ``.npz``) and on a checkpoint directory of the port, in both layouts,
  against the JAX generator on the same frames, atol 2e-6 (float32
  rounding of the convs); ``--int_mode`` bit for bit against JAX's
  ``intsim``.
* ``eval_checkpoint``: the same champion through the port and through
  ``scripts/eval_checkpoint.py`` (independent draws, 20 x 128 frames):
  each row's mean L1 within four standard errors of the difference.
* ``distributional_report``: its JSON layout key for key against
  ``scripts/distributional_report.py``'s, and the clean frames' amplitude
  moments of both within 3 % (two independent draws of 1,024 frames).
* ``benchmark_comparison``: a checkpoint directory of the port through
  both sweeps with GAN-Q, the full U-Net with its quantized row, and the
  refusals; without matplotlib it says so in one line.
* ``utils/params_io.load_params_tree`` on a checkpoint directory, its EMA,
  a flat ``.npz`` (``ema`` raises, as the JAX loader) and an Orbax-like
  directory (raises, naming ``scripts/extract_champion.py``).
* Every CLI raises without a GPU unless given ``--device cpu``.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.quant import intsim as ji
from ofdmgan_tpu_torch import (benchmark_comparison, distributional_report, enhance,
                               eval_checkpoint)
from ofdmgan_tpu_torch.config import Config
from ofdmgan_tpu_torch.models import FullUNetGenerator
from ofdmgan_tpu_torch.training.trainer import Trainer
from ofdmgan_tpu_torch.utils.jax_params import to_jax_params
from ofdmgan_tpu_torch.utils.params_io import load_params_tree, save_params_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
CHAMPION = REPO / "results" / "residual_checkpoints" / "nonlinear" / "champion_params_g.npz"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A checkpoint directory of the port, with an EMA, and a small full U-Net ``.npz``."""
    d = tmp_path_factory.mktemp("ckpt")
    cfg = Config(checkpoint_dir=str(d / "ck"), log_dir=str(d / "logs"),
                 export_dir=str(d / "export"))
    Trainer(cfg, device="cpu", samples_per_epoch=64, val_samples=64, ema_decay=0.9,
            seed=3).save_checkpoint(d / "run")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        full = FullUNetGenerator(frame_length=64, levels=3, base_channels=8)
    save_params_tree(str(d / "full.npz"), to_jax_params(full))
    return d


def _jax_json(script, args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(REPO / "scripts" / script), "--platform", "cpu",
                          *args], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("layout", ["nlc", "ncl"])
@pytest.mark.parametrize("source", ["champion", "directory"])
def test_enhance_matches_jax(tmp_path, ckpt, layout, source):
    path = CHAMPION if source == "champion" else ckpt / "run"
    residual = source == "champion"
    params = load_params_tree(str(path))
    x = (0.3 * np.random.default_rng(1).standard_normal((70, 16, 2))).astype(np.float32)
    np.save(tmp_path / "in.npy", x if layout == "nlc" else x.transpose(0, 2, 1))
    ref = np.asarray(JGen(input_residual=residual).apply(params, x))
    mode = "rtl_residual" if residual else "rtl"
    ref_int = np.asarray(ji.q88_to_float(ji.generator_int_forward(
        ji.quantize_weights_rtl(params), ji.float_to_q88(x), mode)))
    for extra, want, exact in (([], ref, False), (["--int_mode", mode], ref_int, True)):
        enhance.main(["--device", "cpu", "--checkpoint", str(path), "--input",
                      str(tmp_path / "in.npy"), "--output", str(tmp_path / "out.npy"),
                      "--batch_size", "32"] + (["--residual"] if residual else []) + extra)
        got = np.load(tmp_path / "out.npy")
        if layout == "ncl":
            got = got.transpose(0, 2, 1)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    with pytest.raises(SystemExit):
        enhance.main(["--device", "cpu", "--checkpoint", str(path), "--input",
                      str(tmp_path / "in.npy"), "--output", str(tmp_path / "o.npy"),
                      "--residual", "--int_mode", "rtl"])


def test_eval_checkpoint_matches_the_jax_script(ckpt):
    args = ["--residual", "--nonlinear", "--identity", "--checkpoint", str(CHAMPION),
            "--batches", "20", "--batch_size", "128"]
    out = _jax_json("eval_checkpoint.py", args)
    ref = json.loads(out[out.index("{"):])
    got = eval_checkpoint.main(["--device", "cpu"] + args)
    assert list(got) == list(ref)
    for row in ref:
        a, b = got[row], ref[row]
        assert set(b) <= set(a) and a["frames"] == b["frames"] and a["weights"] == b["weights"]
        assert abs(a["val_l1"] - b["val_l1"]) <= 4 * math.hypot(a["val_l1_sem"], b["val_l1_sem"])
    assert got[str(CHAMPION)]["val_l1"] < got["identity"]["val_l1"]
    # a checkpoint directory, its EMA and the integer datapath
    run = str(ckpt / "run")
    res = eval_checkpoint.main(["--device", "cpu", "--checkpoint", run, "--ema", "--int_mode",
                                "rtl", "--batches", "2", "--batch_size", "32"])
    assert res[run]["weights"] == "int:rtl" and res[run]["frames"] == 64
    again = eval_checkpoint.main(["--device", "cpu", "--checkpoint", run, "--ema", "--int_mode",
                                  "rtl", "--batches", "2", "--batch_size", "32"])
    assert again[run]["val_l1"] == res[run]["val_l1"]   # seeded, fixed batches


@pytest.mark.parametrize("extra", [["--serving"], ["--quant_bits", "8", "16"], []])
def test_eval_checkpoint_full_forms(ckpt, extra):
    path = str(ckpt / "full.npz")
    res = eval_checkpoint.main(["--device", "cpu", "--model", "full", "--frame_length", "64",
                                "--checkpoint", path, "--batches", "2", "--batch_size", "8"]
                               + extra)
    assert res[path]["frames"] == 16 and math.isfinite(res[path]["val_l1"])


def test_eval_checkpoint_refusals(ckpt):
    for argv in (["--residual", "--int_mode", "rtl"], ["--serving"], ["--quant_bits", "8", "16"],
                 ["--model", "full", "--int_mode", "rtl"],
                 ["--model", "full", "--serving", "--quant_bits", "8", "16"]):
        with pytest.raises(SystemExit):
            eval_checkpoint.main(["--device", "cpu", "--checkpoint", str(ckpt / "run")] + argv)
    with pytest.raises(SystemExit):   # a flat .npz has no EMA
        eval_checkpoint.main(["--device", "cpu", "--checkpoint", str(CHAMPION), "--ema"])


def test_distributional_report_layout_matches_the_jax_script(tmp_path, ckpt):
    args = ["--residual", "--nonlinear", "--checkpoint", f"champ={CHAMPION}",
            "--batches", "8", "--batch_size", "128", "--mmd_samples", "256"]
    _jax_json("distributional_report.py", args + ["--json", str(tmp_path / "j.json")])
    ref = json.loads((tmp_path / "j.json").read_text())
    got = distributional_report.main(["--device", "cpu", "--json", str(tmp_path / "t.json")]
                                     + args)
    assert json.loads((tmp_path / "t.json").read_text()) == got
    assert list(got) == list(ref) and got["task"] == ref["task"]
    assert list(got["rows"]) == list(ref["rows"]) == ["noisy (no enhancement)", "champ"]
    for label, row in ref["rows"].items():
        assert list(got["rows"][label]) == list(row)
        np.testing.assert_allclose(got["rows"][label]["amp_moments_clean"][:2],
                                   row["amp_moments_clean"][:2], rtol=0.03)
    noisy = got["rows"]["noisy (no enhancement)"]
    assert noisy["mmd2"] > 5 * abs(noisy["mmd2_null_floor"])
    full = distributional_report.main(["--device", "cpu", "--model", "full", "--frame_length",
                                       "64", "--forward", "int8", "--checkpoint",
                                       str(ckpt / "full.npz"), "--batches", "2",
                                       "--batch_size", "16", "--mmd_samples", "32"])
    assert list(full["rows"]) == ["noisy (no enhancement)", "full"]
    with pytest.raises(SystemExit):
        distributional_report.main(["--device", "cpu", "--forward", "serving"])


def test_benchmark_cli_on_a_checkpoint_directory(tmp_path, ckpt, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # the card's machine has none
    lin, nl = benchmark_comparison.main(
        ["--device", "cpu", "--checkpoint", str(ckpt / "run"), "--n_trials", "8",
         "--snr_step", "15", "--quantized", "--protocol", "pilot", "--output_dir",
         str(tmp_path / "out")])
    printed = capsys.readouterr().out
    assert printed.count("matplotlib is not installed") == 1
    assert not list((tmp_path / "out").iterdir())
    assert list(lin) == list(nl) == ["GAN", "GAN-Q", "ZF", "MMSE", "Wiener", "DFE", "LMS", "RLS",
                                     "NoEQ"]
    assert list(lin["NoEQ"]) == [0.0, 15.0, 30.0]
    assert lin["NoEQ"][30.0]["mse"] < lin["NoEQ"][0.0]["mse"]
    lin, nl = benchmark_comparison.main(
        ["--device", "cpu", "--checkpoint", str(ckpt / "full.npz"), "--model", "full",
         "--frame_length", "64", "--n_trials", "4", "--snr_step", "30", "--quantized",
         "--nonlinear", "--output_dir", str(tmp_path / "out2")])
    assert lin is None and "GAN-Q" in nl


@pytest.mark.parametrize("argv", [["--residual", "--int_mode", "rtl"], ["--model", "full", "--qat"],
                                  ["--model", "full"]])
def test_benchmark_cli_refusals(ckpt, argv):
    with pytest.raises(SystemExit):   # the last: a mini checkpoint under --model full
        benchmark_comparison.main(["--device", "cpu", "--checkpoint", str(ckpt / "run"),
                                   "--n_trials", "2"] + argv)


def test_load_params_tree_forms(tmp_path, ckpt):
    run = ckpt / "run"
    flat = load_params_tree(str(run / "params_g.npz"))
    for a, b in zip(jax.tree_util.tree_leaves(load_params_tree(str(run))),
                    jax.tree_util.tree_leaves(flat)):
        np.testing.assert_array_equal(a, b)
    assert set(load_params_tree(str(run), ema=True)["params"]) == set(flat["params"])
    with pytest.raises(SystemExit, match="extract_champion"):
        load_params_tree(str(run / "params_g.npz"), ema=True)
    orbax_like = tmp_path / "orbax"
    (orbax_like / "params_g").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="extract_champion"):
        load_params_tree(str(orbax_like))
    (tmp_path / "no_ema").mkdir()
    save_params_tree(str(tmp_path / "no_ema" / "params_g.npz"), flat)
    with pytest.raises(FileNotFoundError, match="EMA"):
        load_params_tree(str(tmp_path / "no_ema"), ema=True)


@pytest.mark.parametrize("cli", [benchmark_comparison, enhance, eval_checkpoint,
                                 distributional_report])
def test_clis_raise_without_a_gpu(tmp_path, ckpt, cli):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    argv = {enhance: ["--checkpoint", str(ckpt / "run"), "--input", str(tmp_path / "x.npy"),
                      "--output", str(tmp_path / "y.npy")],
            benchmark_comparison: ["--output_dir", str(tmp_path)]}.get(cli, [])
    np.save(tmp_path / "x.npy", np.zeros((2, 16, 2), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
