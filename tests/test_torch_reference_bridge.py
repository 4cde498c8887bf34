"""The original PyTorch repository's checkpoints in the port
(``utils/torch_port.py``), and the ``test_models`` self-check CLI
(``model_selftest``).

The original repository is not here, so its layout is made up: a
``state_dict`` with its keys (``enc1.conv.weight``, ...; the critic's are
the port's) and random values from a seeded numpy generator, bare and in
its training script's checkpoint dict. JAX's bridge
(``ofdmgan_tpu/utils/torch_port.py``) and the port's read it; the two
forwards then agree within float32 rounding (rtol 1e-5, atol 1e-6).
"""

import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.utils import torch_port as jport
from ofdmgan_tpu_torch import model_selftest
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.utils import torch_port
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPES = {
    "generator": {"enc1.conv.weight": (4, 2, 3), "enc1.conv.bias": (4,),
                  "bottleneck.conv.weight": (8, 4, 3), "bottleneck.conv.bias": (8,),
                  "dec1.conv.weight": (4, 8, 3), "dec1.conv.bias": (4,),
                  "out_conv.weight": (2, 4, 3), "out_conv.bias": (2,)},
    "discriminator": {"conv1.weight": (8, 4, 3), "conv1.bias": (8,),
                      "conv2.weight": (16, 8, 3), "conv2.bias": (16,),
                      "dense.weight": (1, 16), "dense.bias": (1,)},
}


def _reference_state(which, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((0.4 * rng.standard_normal(s)).astype(np.float32))
            for k, s in SHAPES[which].items()}


def _frames(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (8, 16, 2)).astype(np.float32)


def _forwards(which, sd_jax, sd_port):
    x, c = _frames(1), _frames(2)
    if which == "generator":
        ref = JGen().apply(jport.generator_params_from_torch(sd_jax), x)
        model = MiniGenerator()
        model.load_state_dict(sd_port)
        got = model(torch.from_numpy(x))
    else:
        ref = JCritic().apply(jport.discriminator_params_from_torch(sd_jax), x, c)
        model = MiniDiscriminator()
        model.load_state_dict(sd_port)
        got = model(torch.from_numpy(x), torch.from_numpy(c))
    return np.asarray(ref), got.detach().numpy()


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_a_reference_state_dict_gives_the_jax_bridges_forward(which):
    sd = _reference_state(which)
    ref, got = _forwards(which, {k: v.numpy() for k, v in sd.items()},
                         torch_port.state_dict_from_reference(sd, which))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_a_reference_checkpoint_file_loads_through_both_bridges(tmp_path, which):
    """The training script's dict, both models in one file, read from disk."""
    path = tmp_path / "checkpoint.pt"
    torch.save({"epoch": 3, "generator_state_dict": _reference_state("generator", 1),
                "discriminator_state_dict": _reference_state("discriminator", 2)}, path)
    ref, got = _forwards(which, jport.load_torch_state_dict(str(path), which),
                         torch_port.load_reference_checkpoint(str(path), which))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_a_state_dict_of_the_other_model_is_refused():
    with pytest.raises(KeyError, match="generator"):
        torch_port.state_dict_from_reference(_reference_state("discriminator"), "generator")
    with pytest.raises(ValueError):
        torch_port.state_dict_from_reference({}, "critic")


def test_model_selftest_passes(capsys):
    assert model_selftest.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[PASS]") == 6 and "6/6 tests passed" in out


def test_model_selftest_fails_on_a_wrong_model(capsys, monkeypatch):
    monkeypatch.setattr("ofdmgan_tpu_torch.models.MiniGenerator",
                        lambda: MiniGenerator(bottleneck_channels=6))
    assert model_selftest.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] parameter count" in out and "[FAIL] RTL channel-progression" in out
    assert "4/6 tests passed" in out
