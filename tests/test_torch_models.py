"""The port's mini models, gradient penalty and weight bridge against the
JAX package.

Weights are made by the flax models and carried to torch by
``from_jax_params``. Tolerance: float32 rounding of 3-tap convolutions
(matmul lowering in JAX, conv1d in torch), atol 1e-5 on activations of
order one and rtol 1e-4 on gradients.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.models import count_parameters as j_count
from ofdmgan_tpu.models.critic import compute_gradient_penalty as j_gp
from ofdmgan_tpu.utils.params_io import load_params_tree as j_load
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator, count_parameters
from ofdmgan_tpu_torch.models.critic import compute_gradient_penalty
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree, load_params_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CHAMPION = (Path(__file__).resolve().parents[1]
            / "results/residual_checkpoints/linear/champion_params_g.npz")
KEY = jax.random.PRNGKey(0)


def _frames(seed, b=32):
    return np.random.default_rng(seed).standard_normal((b, 16, 2)).astype(np.float32) * 0.5


def _ported(module, jparams):
    module.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, jparams)))
    return module


def test_parameter_counts():
    x0 = jnp.zeros((1, 16, 2))
    assert count_parameters(MiniGenerator()) == j_count(JGen().init(KEY, x0)) == 258
    assert count_parameters(MiniDiscriminator()) == j_count(JCritic().init(KEY, x0, x0)) == 521


@pytest.mark.parametrize("which", ["generator", "critic"])
def test_bridge_round_trip(which):
    x0 = jnp.zeros((1, 16, 2))
    tree = (JGen().init(KEY, x0) if which == "generator" else JCritic().init(KEY, x0, x0))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    back = flatten_tree(to_jax_params(from_jax_params(tree)))
    ref = flatten_tree(tree)
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


@pytest.mark.parametrize("residual", [False, True])
def test_generator_forward(residual):
    jg = JGen(input_residual=residual)
    params = jg.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 2)))
    tg = _ported(MiniGenerator(input_residual=residual), params)
    x = _frames(2)
    with torch.no_grad():
        got = tg(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jg.apply(params, x)), atol=1e-5, rtol=1e-5)


def test_critic_forward():
    jc = JCritic()
    params = jc.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 2)), jnp.zeros((1, 16, 2)))
    tc = _ported(MiniDiscriminator(), params)
    a, b = _frames(4), _frames(5)
    with torch.no_grad():
        got = tc(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jc.apply(params, a, b)), atol=1e-5, rtol=1e-5)


def test_gradient_penalty_and_its_parameter_gradients():
    """GP value, its parameter gradient (second order in the critic) and a
    Hessian-vector product of it (third order), against JAX with the same
    per-sample alpha (critic.py:95)."""
    jc = JCritic()
    params = jc.init(jax.random.PRNGKey(6), jnp.zeros((1, 16, 2)), jnp.zeros((1, 16, 2)))
    real, fake, cond = _frames(7), np.tanh(_frames(8)), _frames(9)
    k_gp = jax.random.PRNGKey(10)
    alpha = np.array(jax.random.uniform(k_gp, (real.shape[0], 1, 1), jnp.float32))[:, 0, 0]
    apply = lambda p, c, n: jc.apply(p, c, n)  # noqa: E731

    def gp_of(p):
        return j_gp(apply, p, real, fake, cond, k_gp)

    gp_ref, g_ref = jax.value_and_grad(gp_of)(params)
    v = jax.tree_util.tree_map(lambda x: jnp.ones_like(x) * 0.1, params)
    hvp_ref = jax.jvp(jax.grad(gp_of), (params,), (v,))[1]

    tc = _ported(MiniDiscriminator(), params)
    gp = compute_gradient_penalty(tc, torch.from_numpy(real), torch.from_numpy(fake),
                                  torch.from_numpy(cond), torch.from_numpy(alpha))
    np.testing.assert_allclose(gp.item(), float(gp_ref), rtol=1e-5)
    params_t = list(tc.parameters())
    grads = torch.autograd.grad(gp, params_t, create_graph=True, materialize_grads=True)
    dot = sum((g * 0.1).sum() for g in grads)
    hvp = torch.autograd.grad(dot, params_t, materialize_grads=True)
    names = [n for n, _ in tc.named_parameters()]
    for got, ref in ((grads, g_ref), (hvp, hvp_ref)):
        ref_sd = from_jax_params(jax.tree_util.tree_map(np.asarray, ref))
        for n, g in zip(names, got):
            r = ref_sd[n].numpy()
            np.testing.assert_allclose(g.detach().numpy(), r, rtol=1e-4,
                                       atol=1e-5 * max(1.0, np.abs(r).max()), err_msg=n)


def test_committed_champion_loads_and_matches_the_jax_forward():
    tree = load_params_tree(str(CHAMPION))
    tg = MiniGenerator(input_residual=True)
    tg.load_state_dict(from_jax_params(tree))
    x = _frames(11, 64)
    with torch.no_grad():
        got = tg(torch.from_numpy(x)).numpy()
    ref = JGen(input_residual=True).apply(j_load(str(CHAMPION)), x)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_bridge_rejects_an_unknown_tree():
    with pytest.raises(ValueError):
        from_jax_params({"params": {"w": np.zeros(3)}})


@pytest.mark.parametrize("mode", ["rtl_faithful", "qat"])
def test_unported_generator_modes_raise(mode):
    with pytest.raises(NotImplementedError):
        MiniGenerator(**{mode: True})
