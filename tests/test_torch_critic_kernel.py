"""The critic-gradient kernel's plain version against the Pallas TPU kernel
(in interpret mode, as tests/test_pallas_critic.py:53 runs it) and against
``jax.grad`` of ``critic_loss_fn``, with the same interpolation uniforms.

Tolerance: rtol 1e-5, atol 1e-5 on gradients and metrics of order 0.1-5;
the batch sums are taken in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.ops import pallas_critic as jpc
from ofdmgan_tpu.training.wgan_gp import LossConfig as JLossConfig
from ofdmgan_tpu.training.wgan_gp import critic_loss_fn as j_critic_loss_fn
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.ops import critic_kernel as ck
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, critic_loss_fn
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
METRICS = ("d_loss", "wasserstein_distance", "gradient_penalty", "d_real_mean", "d_fake_mean")


def _setup(b, seed=0):
    jg, jc = JGen(), JCritic()
    x0 = jnp.zeros((1, 16, 2))
    pg, pd = jg.init(jax.random.PRNGKey(seed), x0), jc.init(jax.random.PRNGKey(seed), x0, x0)
    rng = np.random.default_rng(seed + 7)
    clean = rng.standard_normal((b, 16, 2)).astype(np.float32)
    noisy = (clean + 0.3 * rng.standard_normal((b, 16, 2))).astype(np.float32)
    k_gp = jax.random.PRNGKey(seed + 9)
    eps = np.array(jax.random.uniform(k_gp, (b, 1, 1), jnp.float32))[:, 0, 0]
    tg, tc = MiniGenerator(), MiniDiscriminator()
    tg.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, pg)))
    tc.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, pd)))
    return dict(jg=jg, jc=jc, pg=pg, pd=pd, tg=tg, tc=tc, clean=clean, noisy=noisy,
                k_gp=k_gp, eps=eps)


def _port_grads(s):
    noisy, clean = torch.from_numpy(s["noisy"]), torch.from_numpy(s["clean"])
    with torch.no_grad():
        fake = s["tg"](noisy)
    return ck.critic_grad(s["tc"], ck.pack_h0(clean, noisy), ck.pack_h0(fake, noisy),
                          torch.from_numpy(s["eps"]), 10.0)


def _compare(grads, aux, ref_grads, ref_aux):
    ref_sd = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_grads))
    assert grads.keys() == ref_sd.keys()
    for n, r in ref_sd.items():
        np.testing.assert_allclose(grads[n].numpy(), r.numpy(), err_msg=n, **TOL)
    for n in METRICS:
        np.testing.assert_allclose(float(aux[n]), float(ref_aux[n]), err_msg=n, **TOL)


@pytest.mark.parametrize("b,block_rows", [(64, 32), (40, 16)])
def test_plain_version_matches_the_interpreted_tpu_kernel(b, block_rows):
    """B=64 in two grid blocks; B=40 in five blocks of 8 (ragged against the
    CUDA kernel's 16-row tiles)."""
    s = _setup(b)
    fake = s["jg"].apply(s["pg"], s["noisy"])
    with pltpu.force_tpu_interpret_mode():
        ref_grads, ref_aux = jpc.critic_grad_pallas(
            s["pd"], jpc.pack_h0(s["clean"], s["noisy"]), jpc.pack_h0(fake, s["noisy"]),
            jnp.asarray(s["eps"]), JLossConfig(), block_rows=block_rows)
    _compare(*_port_grads(s), ref_grads, ref_aux)


@pytest.mark.parametrize("b", [64, 40])
def test_plain_version_matches_jax_grad(b):
    s = _setup(b, seed=1)
    batch = {"noisy": s["noisy"], "clean": s["clean"]}
    (_, ref_aux), ref_grads = jax.value_and_grad(j_critic_loss_fn, has_aux=True)(
        s["pd"], s["pg"], s["jg"].apply, s["jc"].apply, batch, s["k_gp"], JLossConfig())
    _compare(*_port_grads(s), ref_grads, ref_aux)


def test_plain_version_matches_torch_autograd():
    s = _setup(48, seed=2)
    grads, aux = _port_grads(s)
    batch = {k: torch.from_numpy(s[k]) for k in ("noisy", "clean")}
    loss, ref_aux = critic_loss_fn(s["tc"], s["tg"], batch, torch.from_numpy(s["eps"]),
                                   LossConfig())
    ref = torch.autograd.grad(loss, list(s["tc"].parameters()))
    for (n, _), r in zip(s["tc"].named_parameters(), ref):
        torch.testing.assert_close(grads[n], r, **TOL)
    for n in METRICS:
        torch.testing.assert_close(aux[n], ref_aux[n], **TOL)


def test_penalty_second_order_terms_contribute():
    s = _setup(32, seed=3)
    mats = ck.critic_dense_mats(s["tc"])
    h0 = torch.randn(32, 64, generator=torch.Generator().manual_seed(0))
    eps = torch.from_numpy(s["eps"])
    with_gp = ck.critic_grad_plain(h0, torch.tanh(h0), eps, mats, 10.0)
    without = ck.critic_grad_plain(h0, torch.tanh(h0), eps, mats, 0.0)
    assert float((with_gp["gA1"] - without["gA1"]).abs().max()) > 1e-4


def test_dense_mats_and_grad_mapping_match_jax():
    s = _setup(8, seed=4)
    mats, jmats = ck.critic_dense_mats(s["tc"]), jpc.critic_dense_mats(s["pd"])
    for k in ("a1", "a2", "b1", "b2", "q2", "bd"):
        np.testing.assert_array_equal(mats[k].numpy(), np.asarray(jmats[k]), err_msg=k)
    rng = np.random.default_rng(5)
    dense = {"gA1": rng.standard_normal((64, 64)), "gA2": rng.standard_normal((64, 64)),
             "gb1": rng.standard_normal(64), "gb2": rng.standard_normal(64),
             "gw": rng.standard_normal(16)}
    dense = {k: v.astype(np.float32) for k, v in dense.items()}
    got = ck.dense_grads_to_params(s["tc"], {k: torch.from_numpy(v) for k, v in dense.items()})
    ref = jpc.dense_grads_to_params(dense["gA1"], dense["gb1"], dense["gA2"], dense["gb2"],
                                    dense["gw"], s["pd"])
    ref_sd = from_jax_params(jax.tree_util.tree_map(np.asarray, ref))
    for n, r in ref_sd.items():
        np.testing.assert_allclose(got[n].numpy(), r.numpy(), rtol=1e-6, atol=1e-6, err_msg=n)


def test_cpu_wrapper_takes_the_plain_version():
    s = _setup(16, seed=5)
    before = ck.launches
    _port_grads(s)
    assert ck.launches == before


def test_other_critic_shapes_raise():
    with pytest.raises(ValueError):
        ck.critic_dense_mats(MiniDiscriminator(conv1_channels=4))
