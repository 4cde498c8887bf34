"""The port's fused-decoder forward and functional full critic against the
JAX package's ``models/unet_infer.py``.

A three-level, base-8 U-Net at L = 64 with flax-initialised weights and
numpy frames. The port's unfused forward is the module's own, held
against JAX's unfused apply. Tolerances, those of
``tests/test_unet_infer.py``: at float32 the fused decoder against an
unfused forward (the port's module, JAX's module) atol 1e-5 on the tanh
output (the summed taps w1+w2 and w0+w1 round before the products are
summed), and each forward against its JAX counterpart atol 1e-5; the
parameter gradients through the fused forward rtol 5e-4, atol 5e-6; the
critic rtol 1e-5, atol 1e-5. At bfloat16 the fused tanh outputs agree with
JAX's fused bf16 apply and with JAX's float32 module within the
reference's own bf16 bounds (largest difference 0.05, mean 5e-3), and the
critic scores within rtol 0.05, atol 0.2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models.full_unet import FullDiscriminator as JCritic
from ofdmgan_tpu.models.full_unet import FullUNetGenerator as JGen
from ofdmgan_tpu.models.unet_infer import make_full_critic_apply as j_critic_apply
from ofdmgan_tpu.models.unet_infer import make_unet_infer_apply as j_infer_apply
from ofdmgan_tpu_torch.models.full_unet import FullDiscriminator, FullUNetGenerator
from ofdmgan_tpu_torch.models.unet_infer import make_full_critic_apply, make_unet_infer_apply
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LEVELS, BASE, L = 3, 8, 64
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _models():
    """JAX params and port modules of a generator and a critic on the same
    weights, and numpy frames; shared by the tests, which leave them unchanged."""
    x0 = jnp.zeros((1, L, 2))
    pg = jax.jit(JGen(frame_length=L, levels=LEVELS, base_channels=BASE).init)(
        jax.random.PRNGKey(7), x0)
    pd = jax.jit(JCritic(frame_length=L, levels=LEVELS, base_channels=BASE).init)(
        jax.random.PRNGKey(11), x0, x0)
    tg = FullUNetGenerator(frame_length=L, levels=LEVELS, base_channels=BASE)
    tc = FullDiscriminator(frame_length=L, levels=LEVELS, base_channels=BASE)
    tg.load_state_dict(from_jax_params(_np(pg)))
    tc.load_state_dict(from_jax_params(_np(pd)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, L, 2)).astype(np.float32)
    cond = rng.standard_normal((4, L, 2)).astype(np.float32)
    return pg, pd, tg, tc, x, cond


def _apply(dtype="float32"):
    return make_unet_infer_apply(levels=LEVELS, act_dtype=DTYPES[dtype][0])


def test_module_forward_matches_jax_unfused_apply():
    pg, _, tg, _, x, _ = _models()
    ref = jax.jit(j_infer_apply(levels=LEVELS, act_dtype=jnp.float32, fused_decoder=False))(pg, x)
    with torch.no_grad():
        got = tg(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)


def test_fused_decoder_matches_the_unfused_forward():
    _, _, tg, _, x, _ = _models()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        torch.testing.assert_close(_apply()(tg, xt), tg(xt), rtol=0, atol=1e-5)


@pytest.mark.parametrize("against", ["jax_fused_apply", "jax_module"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(against, dtype):
    """The fused apply against JAX's fused apply at the same ``act_dtype``,
    or against JAX's float32 module forward (the unfused decoder)."""
    pg, _, tg, _, x, _ = _models()
    if against == "jax_fused_apply":
        j_apply = jax.jit(j_infer_apply(levels=LEVELS, act_dtype=DTYPES[dtype][1]))
    else:
        j_apply = jax.jit(JGen(frame_length=L, levels=LEVELS, base_channels=BASE).apply)
    ref = np.asarray(j_apply(pg, x).astype(jnp.float32))
    with torch.no_grad():
        got = _apply(dtype)(tg, torch.from_numpy(x))
    assert got.dtype == DTYPES[dtype][0]
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        assert np.max(np.abs(got - ref)) < 0.05
        assert np.mean(np.abs(got - ref)) < 5e-3


def test_fused_training_forward_gradients_match_jax():
    """Parameter gradients of a supervised L1 loss through the fused
    forward, against JAX's (tests/test_unet_infer.py:69-90)."""
    pg, _, tg, _, x, _ = _models()
    target = np.tanh(x * 0.5)
    j_apply = j_infer_apply(levels=LEVELS, act_dtype=jnp.float32, fused_decoder=True)
    g_ref = jax.jit(jax.grad(lambda p: jnp.mean(jnp.abs(j_apply(p, x) - target))))(pg)
    g_ref = from_jax_params(_np(g_ref))
    loss = (_apply()(tg, torch.from_numpy(x)) - torch.from_numpy(target)).abs().mean()
    names = [n for n, _ in tg.named_parameters()]
    grads = torch.autograd.grad(loss, list(tg.parameters()))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), g_ref[name].numpy(), rtol=5e-4, atol=5e-6,
                                   err_msg=name)


def test_bfloat16_forward_keeps_float32_parameter_gradients():
    _, _, tg, _, x, _ = _models()
    out = _apply("bfloat16")(tg, torch.from_numpy(x))
    grads = torch.autograd.grad(out.float().square().mean(), list(tg.parameters()))
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_critic_apply_matches_jax(dtype):
    _, pd, _, tc, x, cond = _models()
    ref = np.asarray(jax.jit(j_critic_apply(levels=LEVELS, act_dtype=DTYPES[dtype][1]))(
        pd, x, cond))
    with torch.no_grad():
        got = make_full_critic_apply(levels=LEVELS, act_dtype=DTYPES[dtype][0])(
            tc, torch.from_numpy(x), torch.from_numpy(cond))
    assert got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got.numpy(), tc(torch.from_numpy(x), torch.from_numpy(cond)).detach().numpy(),
            rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0.05, atol=0.2)


def test_act_dtype_is_float32_or_bfloat16():
    with pytest.raises(ValueError):
        make_unet_infer_apply(act_dtype=torch.float16)
    with pytest.raises(ValueError):
        make_full_critic_apply(act_dtype=torch.float8_e4m3fn)
