"""The QAT helpers ``FakeQuantize`` and ``QuantizedConv1d`` and the integer
datapath's ``quantization_error_report`` against the JAX package's
(``ofdmgan_tpu/quant/fakequant.py:35-84``, ``quant/intsim.py:230-247``).

Tolerances: the fake-quantized forwards compute the same float32
round-and-clamp on the same scale (a maximum, exact) and the same sums, so
activations agree to float32 rounding, atol 1e-6 (a value exactly halfway
between two steps could round apart: none is here); the running max bit
for bit; the report's numbers rtol 1e-4 (its integer output is bit for bit,
its float reference is float32 convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.quant import intsim as jintsim
from ofdmgan_tpu.quant.fakequant import FakeQuantize as JFakeQuantize
from ofdmgan_tpu.quant.fakequant import QuantizedConv1d as JQuantizedConv1d
from ofdmgan_tpu_torch.models import MiniGenerator
from ofdmgan_tpu_torch.quant import intsim
from ofdmgan_tpu_torch.quant.fakequant import FakeQuantize, QuantizedConv1d, fake_quantize_auto
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_fakequantize_ema_as_the_reference():
    """``running_max``: 0.9 * 0 + 0.1 * 2 after one training call on twos,
    then three more calls on other batches, each output and running max
    against JAX's; evaluation quantizes with the running max."""
    jm, tm = JFakeQuantize(n_bits=8), FakeQuantize(n_bits=8)
    x = jnp.ones((4,)) * 2.0
    variables = jm.init(KEY, x)
    y, mut = jm.apply(variables, x, mutable=["batch_stats"])
    got = tm(torch.from_numpy(np.array(x)))
    assert abs(float(tm.running_max) - 0.2) < 1e-6
    assert float(tm.running_max) == float(mut["batch_stats"]["running_max"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), atol=1e-6)
    rng = np.random.default_rng(3)
    for i in range(3):
        x = rng.standard_normal((8, 5)).astype(np.float32) * (i + 1)
        y, mut = jm.apply({"batch_stats": mut["batch_stats"]}, x, mutable=["batch_stats"])
        got = tm(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), atol=1e-6)
        assert float(tm.running_max) == float(mut["batch_stats"]["running_max"])
    x = rng.standard_normal((8, 5)).astype(np.float32)
    y_eval = jm.apply({"batch_stats": mut["batch_stats"]}, x, train=False)
    tm.eval()
    before = float(tm.running_max)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(y_eval),
                               atol=1e-6)
    assert float(tm.running_max) == before
    assert flatten_tree(to_jax_params(tm)) == {"batch_stats/running_max": np.float32(before)}


@pytest.mark.parametrize("stride", [1, 2])
def test_quantized_conv_matches_the_reference(stride):
    """JAX's initialized module carried across (its kernel and its running
    max), a training call on each side, then an evaluation call; the
    gradient is the straight-through one."""
    jm = JQuantizedConv1d(features=4, stride=stride)
    x = np.array(jax.random.normal(KEY, (2, 16, 2)))
    variables = jm.init(KEY, x)
    tm = QuantizedConv1d(2, 4, stride=stride)
    tm.load_state_dict(from_jax_params(_np(variables)))
    y, mut = jm.apply(variables, x, mutable=["batch_stats"])
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm(xt)
    assert got.shape == y.shape == (2, 16 // stride, 4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), atol=1e-6)
    back = flatten_tree(to_jax_params(tm))
    ref = flatten_tree(_np({"params": variables["params"], **mut}))
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    y_eval = jm.apply({"params": variables["params"], **mut}, x, train=False)
    tm.eval()
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(y_eval),
                               atol=1e-6)
    (g,) = torch.autograd.grad(got.sum(), xt)
    w = fake_quantize_auto(tm.weight.detach(), 8, per_channel=True, channel_axis=0)
    want = torch.nn.functional.conv_transpose1d(torch.ones(2, 4, 16 // stride), w,
                                                stride=stride, padding=1,
                                                output_padding=stride - 1)
    np.testing.assert_allclose(g.numpy(), want.transpose(1, 2).numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", ["rtl", "float_ref"])
def test_quantization_error_report(mode):
    """The report on a module and on a flax tree, against JAX's on the
    same parameters and frames."""
    params = _np(JGen().init(KEY, jnp.zeros((1, 16, 2))))
    x = (np.random.default_rng(5).standard_normal((64, 16, 2)) * 0.4).astype(np.float32)
    ref = jintsim.quantization_error_report(params, jnp.asarray(x), mode)
    g = MiniGenerator()
    g.load_state_dict(from_jax_params(params))
    for p in (params, g):
        got = intsim.quantization_error_report(p, torch.from_numpy(x), mode)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    assert 0 < ref["mse"] < ref["rms_float"] ** 2
