"""The port's FPGA export, Verilog ROM and export CLIs against the JAX
package, on the CPU.

Bundles (``.bin`` files and ``metadata.json``) are compared byte for byte
with ``ofdmgan_tpu.quant.export``'s on the same parameters, given to the
port as its models and as flax-layout trees; ROM sources line for line with
``ofdmgan_tpu.quant.rom_codegen``'s but for the one comment line that names
the generator, and their parsed arrays exactly.
"""

import filecmp
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.models.full_unet import FullUNetGenerator as JFull
from ofdmgan_tpu.quant import export as jexp
from ofdmgan_tpu.quant import rom_codegen as jrom
from ofdmgan_tpu_torch import export as export_cli
from ofdmgan_tpu_torch import export_mini_weights as rom_cli
from ofdmgan_tpu_torch import train as train_cli
from ofdmgan_tpu_torch.config import Config, TrainingSection
from ofdmgan_tpu_torch.models import FullUNetGenerator, MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.quant import export as texp
from ofdmgan_tpu_torch.quant import rom_codegen as trom
from ofdmgan_tpu_torch.training.trainer import Trainer, build_models
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
from ofdmgan_tpu_torch.utils.params_io import load_params_tree, save_params_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
BIAS_FORMATS = ("float32", "int32_q1616")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _perturbed(tree, seed):
    """Trained-looking parameters: non-zero biases, weights past +-1."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a * 2.0 + rng.standard_normal(a.shape) * 0.05).astype(np.float32), tree)


def _loaded(module, tree):
    module.load_state_dict(from_jax_params(tree))
    return module


@pytest.fixture(scope="module")
def mini_pair():
    x0 = jnp.zeros((1, 16, 2))
    pg = _perturbed(_np(JGen().init(jax.random.PRNGKey(1), x0)), 1)
    pd = _perturbed(_np(JCritic().init(jax.random.PRNGKey(2), x0, x0)), 2)
    return pg, pd, _loaded(MiniGenerator(), pg), _loaded(MiniDiscriminator(), pd)


@pytest.fixture(scope="module")
def full5():
    """A full U-Net at the published widths (levels 5, base 32): the shapes
    the mini ROM slicing reads."""
    params = _perturbed(_np(JFull(frame_length=64).init(jax.random.PRNGKey(3),
                                                        jnp.zeros((1, 64, 2)))), 3)
    return params, _loaded(FullUNetGenerator(frame_length=64), params)


def _same_dirs(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name
    return names


@pytest.mark.parametrize("bias_format", BIAS_FORMATS)
@pytest.mark.parametrize("which", ["generator", "critic"])
def test_mini_bundles_are_byte_identical(tmp_path, mini_pair, which, bias_format):
    pg, pd, tg, td = mini_pair
    tree, module = (pg, tg) if which == "generator" else (pd, td)
    j_fn, t_fn = ((jexp.export_generator, texp.export_generator) if which == "generator"
                  else (jexp.export_discriminator, texp.export_discriminator))
    ref = j_fn(tree, str(tmp_path / "jax"), write_bias_format=bias_format)
    for src, name in ((module, "module"), (tree, "tree")):
        assert t_fn(src, str(tmp_path / name), write_bias_format=bias_format) == ref
        names = _same_dirs(tmp_path / "jax", tmp_path / name)
    assert len(names) == 3 * len(ref["layers"]) + 1


@pytest.mark.parametrize("bias_format", BIAS_FORMATS)
def test_full_bundle_is_byte_identical(tmp_path, bias_format):
    jf = JFull(frame_length=64, levels=3, base_channels=8)
    params = _perturbed(_np(jf.init(jax.random.PRNGKey(4), jnp.zeros((1, 64, 2)))), 4)
    tf = _loaded(FullUNetGenerator(frame_length=64, levels=3, base_channels=8), params)
    ref = jexp.export_full_unet(params, str(tmp_path / "jax"), write_bias_format=bias_format)
    assert texp.export_full_unet(tf, str(tmp_path / "port"), write_bias_format=bias_format) == ref
    assert texp.export_any_generator(params, str(tmp_path / "any"),
                                     write_bias_format=bias_format) == ref
    assert len(_same_dirs(tmp_path / "jax", tmp_path / "port")) == 3 * 15 + 1   # 15 layers
    _same_dirs(tmp_path / "jax", tmp_path / "any")
    assert [s.name for s in texp.full_unet_layers(tf)] == list(ref["layers"])


def _rom_lines(path, generated_by):
    lines = Path(path).read_text().splitlines()
    assert lines[1] == generated_by
    return lines[:1] + lines[2:]


@pytest.mark.parametrize("int_source", ["q17", "int8"])
@pytest.mark.parametrize("with_critic", [False, True])
def test_rom_source_matches_and_parses_back(tmp_path, mini_pair, int_source, with_critic):
    pg, pd, tg, td = mini_pair
    ref_n = jrom.generate_rom_verilog(pg, pd if with_critic else None, str(tmp_path / "j.v"),
                                      int_source)
    got_n = trom.generate_rom_verilog(tg, td if with_critic else None, str(tmp_path / "t.v"),
                                      int_source)
    assert got_n == ref_n == ((720, 43) if with_critic else (224, 18))
    assert _rom_lines(tmp_path / "t.v", trom.GENERATED_BY) == _rom_lines(
        tmp_path / "j.v", "// weight_rom / bias_rom — generated by ofdmgan_tpu.quant.rom_codegen")
    packed = trom.pack_rom_arrays(tg, td if with_critic else None, int_source)
    for got, want in zip(trom.parse_rom_verilog(str(tmp_path / "t.v")),
                         jrom.parse_rom_verilog(str(tmp_path / "j.v"))):
        np.testing.assert_array_equal(got, want)
    for got, want, packed_arr in zip(trom.parse_rom_verilog(str(tmp_path / "t.v")),
                                     jrom.pack_rom_arrays(pg, pd if with_critic else None,
                                                          int_source), packed):
        np.testing.assert_array_equal(got, want.astype(np.int32))
        np.testing.assert_array_equal(packed_arr, want)
    for got, want in zip(trom.unpack_rom_arrays(*packed), jrom.unpack_rom_arrays(*packed)):
        for g_layer, w_layer in zip(got, want):
            np.testing.assert_array_equal(g_layer.weight, w_layer.weight)
            np.testing.assert_array_equal(g_layer.bias, w_layer.bias)


@pytest.mark.parametrize("bias_format", BIAS_FORMATS)
def test_full_export_slices_to_the_mini_rom(tmp_path, full5, bias_format):
    params, tf = full5
    texp.export_full_unet(tf, str(tmp_path / "export"), write_bias_format=bias_format)
    for got, want in zip(trom.slice_full_export_to_mini(str(tmp_path / "export"), bias_format),
                         jrom.slice_full_export_to_mini(str(tmp_path / "export"), bias_format)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert trom.generate_mini_rom_from_full_export(str(tmp_path / "export"), str(tmp_path / "t.v"),
                                                   bias_format) == (224, 18)
    jrom.generate_mini_rom_from_full_export(str(tmp_path / "export"), str(tmp_path / "j.v"),
                                            bias_format)
    assert _rom_lines(tmp_path / "t.v", trom.GENERATED_BY) == _rom_lines(
        tmp_path / "j.v", "// weight_rom / bias_rom — generated by ofdmgan_tpu.quant.rom_codegen")


def _config(tmp_path, **kw):
    return Config(training=TrainingSection(batch_size=16), checkpoint_dir=str(tmp_path / "c"),
                  log_dir=str(tmp_path / "l"), export_dir=str(tmp_path / "e"), **kw)


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_trainer_exports_the_raw_generator(tmp_path, ema):
    """After ``final_model/`` the run writes the raw generator's bundle (not
    the EMA's), as ``quant.export`` writes it from the saved parameters."""
    cfg = _config(tmp_path)
    g, d = build_models(cfg, "mini", 0, qat=True)
    trainer = Trainer(cfg, samples_per_epoch=32, val_samples=16, device="cpu", ema_decay=ema,
                      generator=g, discriminator=d)
    trainer.train(epochs=1, experiment_name="x")
    jexp.export_generator(load_params_tree(str(tmp_path / "c" / "final_params_g.npz")),
                          str(tmp_path / "jax"))
    _same_dirs(tmp_path / "jax", tmp_path / "e" / "generator")


def test_export_can_be_switched_off(tmp_path, capsys):
    trainer = Trainer(_config(tmp_path, export_after_training=False), samples_per_epoch=16,
                      val_samples=16, device="cpu")
    trainer.train(epochs=1)
    assert not (tmp_path / "e").exists()
    cli = ["--device", "cpu", "--epochs", "1", "--batch_size", "16", "--samples_per_epoch", "16",
           "--val_samples", "16", "--checkpoint_dir", str(tmp_path / "c2"), "--log_dir",
           str(tmp_path / "l2"), "--export_dir", str(tmp_path / "e2")]
    train_cli.main(cli + ["--skip_export"])
    assert "Exporting" not in capsys.readouterr().out and not (tmp_path / "e2").exists()
    args = train_cli.build_parser().parse_args(["--skip_export", "--export_dir", "x"])
    cfg = train_cli.config_from_args(args)
    assert (cfg.export_after_training, cfg.export_dir) == (False, "x")
    assert Config().export_dir == "./export" and Config().export_after_training


def test_yaml_keys_set_the_export():
    from ofdmgan_tpu_torch.config import config_from_dict

    cfg = config_from_dict({"paths": {"export_dir": "/x"}, "export_after_training": False})
    assert (cfg.export_dir, cfg.export_after_training) == ("/x", False)
    assert config_from_dict({}).export_dir == "./export"


def test_export_only_takes_a_checkpoint_or_a_generator_npz(tmp_path, mini_pair, full5, capsys):
    pg, pd, tg, td = mini_pair
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    save_params_tree(str(ckpt / "params_g.npz"), pg)
    save_params_tree(str(tmp_path / "full.npz"), full5[0])
    for src, jfn, params, name in ((ckpt, jexp.export_generator, pg, "mini"),
                                   (tmp_path / "full.npz", jexp.export_full_unet, full5[0],
                                    "full")):
        assert train_cli.main(["--export_only", "--export_checkpoint", str(src),
                               "--export_dir", str(tmp_path / name)]) is None
        jfn(params, str(tmp_path / f"{name}_jax"))
        _same_dirs(tmp_path / f"{name}_jax", tmp_path / name / "generator")
    assert "Export complete." in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        train_cli.main(["--export_only", "--export_checkpoint", str(tmp_path / "none")])
    with pytest.raises(FileNotFoundError):
        train_cli.main(["--export_only"])


@pytest.mark.parametrize("bias_format", BIAS_FORMATS)
def test_export_cli(tmp_path, mini_pair, bias_format):
    pg, pd, _, _ = mini_pair
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    save_params_tree(str(ckpt / "params_g.npz"), pg)
    save_params_tree(str(ckpt / "params_d.npz"), pd)
    export_cli.main(["--checkpoint", str(ckpt), "--export_dir", str(tmp_path / "out"),
                     "--discriminator", "--bias_format", bias_format])
    jexp.export_generator(pg, str(tmp_path / "jg"), write_bias_format=bias_format)
    jexp.export_discriminator(pd, str(tmp_path / "jd"), write_bias_format=bias_format)
    _same_dirs(tmp_path / "jg", tmp_path / "out" / "generator")
    _same_dirs(tmp_path / "jd", tmp_path / "out" / "discriminator")
    export_cli.main(["--checkpoint", str(ckpt / "params_g.npz"), "--export_dir",
                     str(tmp_path / "g_only"), "--discriminator"])
    assert [p.name for p in (tmp_path / "g_only").iterdir()] == ["generator"]
    with pytest.raises(FileNotFoundError):   # a directory without params_g.npz
        export_cli.main(["--checkpoint", str(tmp_path / "out"), "--export_dir",
                         str(tmp_path / "none")])


def test_export_mini_weights_cli(tmp_path, full5, capsys):
    params, tf = full5
    texp.export_full_unet(tf, str(tmp_path / "export"))
    rom_cli.main(["--export_dir", str(tmp_path / "export"), "--output", str(tmp_path / "r" / "w.v")])
    assert "Generated" in capsys.readouterr().out
    jrom.generate_mini_rom_from_full_export(str(tmp_path / "export"), str(tmp_path / "j.v"))
    assert _rom_lines(tmp_path / "r" / "w.v", trom.GENERATED_BY) == _rom_lines(
        tmp_path / "j.v", "// weight_rom / bias_rom — generated by ofdmgan_tpu.quant.rom_codegen")
    # no export: a fresh mini pair from seed 0, generator and critic
    rom_cli.main(["--export_dir", str(tmp_path / "none"), "--output", str(tmp_path / "f.v")])
    assert "using fresh mini weights" in capsys.readouterr().out
    weights, biases = trom.parse_rom_verilog(str(tmp_path / "f.v"))
    assert np.count_nonzero(weights[:224]) > 0 and np.count_nonzero(weights[256:752]) > 0
    assert np.count_nonzero(weights[224:256]) == 0 and np.count_nonzero(weights[752:]) == 0


def test_clis_run_as_modules(tmp_path, mini_pair):
    """``python -m`` runs each CLI from the repository root."""
    pg = mini_pair[0]
    save_params_tree(str(tmp_path / "g.npz"), pg)
    for cmd in (["ofdmgan_tpu_torch.export", "--checkpoint", str(tmp_path / "g.npz"),
                 "--export_dir", str(tmp_path / "x")],
                ["ofdmgan_tpu_torch.export_mini_weights", "--export_dir", str(tmp_path / "x"),
                 "--output", str(tmp_path / "w.v")]):
        out = subprocess.run([sys.executable, "-m", *cmd], cwd=REPO, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr
    meta = json.loads((tmp_path / "x" / "generator" / "metadata.json").read_text())
    assert list(meta["layers"]) == ["enc1.conv", "bottleneck.conv", "dec1.conv", "out_conv"]
    assert (tmp_path / "w.v").exists() and torch.__version__
