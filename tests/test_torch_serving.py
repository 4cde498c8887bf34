"""The port's serving export (``export_serving``) against the JAX package's
committed StableHLO artifacts.

* The mini residual champion exported in float32 and loaded back computes
  what ``results/serving/mini_residual_nonlinear.stablehlo`` computes
  (deserialized on the CPU with ``jax.export``) at batches 1, 9 and 33
  through one dynamic-batch program: atol 1e-6, float32 rounding of one
  forward.
* The full champion's bfloat16 serving export against
  ``results/serving/full_awgn_nonlinear.stablehlo`` on 2 frames. Both are
  bf16 forwards of one function, rounded at different points: XLA's CPU
  keeps excess precision between ops, ATen rounds every op's output to
  bf16. Their distance is that of either from the float32 forward, so the
  bound is 1.5 times the artifact's own distance from JAX's float32 fused
  forward, by the largest and by the mean difference (measured on the CPU:
  port against artifact 0.0502 / 0.0056, artifact against float32 0.0467 /
  0.0050). The JAX package's 2e-2 (``tests/test_export_serving.py``) holds
  XLA against XLA, where the two agree exactly. The float32 export of the
  same champion equals JAX's float32 fused forward within atol 1e-5.
* A reduced U-Net (L = 64, three levels, base 8) round trip, the metadata,
  and the selftest failing on a damaged or foreign artifact.
"""

import json
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jexport

from ofdmgan_tpu.models.unet_infer import make_unet_infer_apply as j_infer_apply
from ofdmgan_tpu.utils.params_io import load_params_tree as j_load_params
from ofdmgan_tpu_torch import export_serving
from ofdmgan_tpu_torch.models.full_unet import FullUNetGenerator
from ofdmgan_tpu_torch.utils.params_io import load_params_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
MINI_CHAMPION = "results/residual_checkpoints/nonlinear/champion_params_g.npz"
FULL_CHAMPION = "results/full_unet_run/champion_params_g.npz"
SERVING = REPO / "results/serving"


def _export(tmp_path, *args):
    out = tmp_path / "artifact"
    meta = export_serving.main(["--device", "cpu", "--out", str(out), *args])
    return out, meta


def _load(out):
    return torch.export.load(str(out.with_suffix(".pt2"))).module()


def _jax_artifact(stem):
    return jexport.deserialize((SERVING / f"{stem}.stablehlo").read_bytes())


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return _export(tmp_path_factory.mktemp("mini"), "--model", "mini", "--residual",
                   "--checkpoint", str(REPO / MINI_CHAMPION))


@pytest.mark.parametrize("batch", [1, 9, 33])
def test_mini_export_matches_the_committed_jax_artifact(mini, batch):
    program = _load(mini[0])
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(batch), (batch, 16, 2)))
    want = np.asarray(_jax_artifact("mini_residual_nonlinear").call(x))
    with torch.no_grad():
        got = program(torch.from_numpy(np.array(x))).numpy()
    assert got.shape == (batch, 16, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def full_frames():
    """Two frames, the committed artifact's output on them and JAX's float32
    fused forward of the same champion."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (2, 1024, 2)))
    params = j_load_params(str(REPO / FULL_CHAMPION))
    f32 = np.asarray(jax.jit(lambda x: j_infer_apply(act_dtype=jnp.float32)(params, x))(x))
    return x, np.asarray(_jax_artifact("full_awgn_nonlinear").call(x)), f32


def test_full_bf16_export_matches_the_committed_jax_artifact(tmp_path, capsys, full_frames):
    x, want, f32 = full_frames
    out, meta = _export(tmp_path, "--model", "full", "--checkpoint", str(REPO / FULL_CHAMPION))
    assert "selftest: PASS" in capsys.readouterr().out
    assert meta["act_dtype"] == "bfloat16" and meta["n_params_baked"] == 3_936_578
    with torch.no_grad():
        got = _load(out)(torch.from_numpy(np.array(x))).numpy()
    assert got.shape == (2, 1024, 2) and got.dtype == np.float32
    own = np.abs(want - f32)
    diff = np.abs(got - want)
    assert diff.max() <= 1.5 * own.max() and diff.mean() <= 1.5 * own.mean()


def test_full_float32_export_computes_the_jax_fused_forward(tmp_path, full_frames):
    x, _, f32 = full_frames
    out, meta = _export(tmp_path, "--model", "full", "--act_dtype", "float32",
                        "--checkpoint", str(REPO / FULL_CHAMPION))
    with torch.no_grad():
        got = _load(out)(torch.from_numpy(np.array(x))).numpy()
    np.testing.assert_allclose(got, f32, rtol=0, atol=1e-5)


def test_metadata_describes_the_artifact(mini):
    out, meta = mini
    assert json.loads(out.with_suffix(".metadata.json").read_text())["artifact_sha256"] == \
        meta["artifact_sha256"]
    art = out.with_suffix(".pt2")
    assert art.stat().st_size == meta["artifact_bytes"]
    assert meta["n_params_baked"] == 258
    assert meta["input"].startswith("[b, 16, 2]")
    assert meta["device"] == "cpu" and meta["torch_version"] == torch.__version__
    assert (meta["model"], meta["residual"], meta["ema"], meta["act_dtype"]) == \
        ("mini", True, False, "float32")
    assert meta["selftest_max_abs_diff"] < 1e-5
    assert "torch.export.load" in meta["load_with"]


def test_a_fixed_batch_export(tmp_path):
    out, meta = _export(tmp_path, "--model", "mini", "--batch", "3", "--no_selftest",
                        "--checkpoint", str(REPO / MINI_CHAMPION))
    assert meta["input"].startswith("[3, 16, 2]") and "selftest_max_abs_diff" not in meta
    with torch.no_grad():
        assert _load(out)(torch.zeros(3, 16, 2)).shape == (3, 16, 2)


@pytest.mark.parametrize("act_dtype,atol", [(torch.float32, 1e-6), (torch.bfloat16, 1e-2)])
def test_a_reduced_unet_round_trip(tmp_path, act_dtype, atol):
    torch.manual_seed(0)
    gen = FullUNetGenerator(frame_length=64, levels=3, base_channels=8)
    with torch.no_grad():
        want_f32 = gen(torch.randn(5, 64, 2, generator=torch.Generator().manual_seed(1)))
    forward = export_serving.ServingForward(gen, True, act_dtype).eval()
    path = tmp_path / "reduced.pt2"
    torch.export.save(export_serving.export_program(forward, 64, "symbolic", "cpu"), str(path))
    name = "float32" if act_dtype == torch.float32 else "bfloat16"
    assert export_serving.selftest(path, forward, 64, name, "cpu") == 0.0
    x = torch.randn(5, 64, 2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = torch.export.load(str(path)).module()(x)
    # the fused decoder in float32 is the module's forward; in bf16 within its rounding
    torch.testing.assert_close(got, want_f32, rtol=0, atol=atol)


def test_the_selftest_fails_on_a_foreign_or_damaged_artifact(mini, tmp_path):
    out, _ = mini
    art = out.with_suffix(".pt2")
    tree = load_params_tree(str(REPO / MINI_CHAMPION))
    tree["params"]["out_conv_bias"] = tree["params"]["out_conv_bias"] + 0.01
    other, L = export_serving.build_forward("mini", tree, True, "float32", 16)
    with pytest.raises(SystemExit, match="selftest FAILED"):
        export_serving.selftest(art, other.eval(), L, "float32", "cpu")

    damaged = tmp_path / "damaged.pt2"
    with zipfile.ZipFile(art) as src, zipfile.ZipFile(damaged, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if "/weights/weight_" in item.filename:   # every weight's bytes
                data = bytes(b ^ 0x40 for b in data)
            dst.writestr(item, data)
    forward, L = export_serving.build_forward("mini", load_params_tree(
        str(REPO / MINI_CHAMPION)), True, "float32", 16)
    with pytest.raises(SystemExit, match="selftest FAILED"):
        export_serving.selftest(damaged, forward.eval(), L, "float32", "cpu")
