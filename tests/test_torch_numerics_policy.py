"""The port's numerics policy: TF32 off from the import on, and the bf16
matmul modes as the reference computes them.

* Importing the port turns TF32 off for matrix products and cuDNN
  convolutions, checked in a fresh interpreter after importing one module
  whose functions take CUDA modules without calling ``resolve_device``.
* Under ``matmul_precision("bfloat16")`` every conv and linear reads
  bf16-rounded operands and returns float32, as
  ``jax.default_matmul_precision("bfloat16")`` computes on a TPU; XLA's CPU
  ignores that setting, so the JAX side runs through ``with_bf16_operands``
  (``tests/jax_bf16_dots.py``), which rounds the operands of every dot and
  convolution of the traced function, its transposes included. Tolerance:
  float32 rounding, rtol 1e-5 (bf16 products are exact in float32; only the
  sums' order differs), atol 1e-6 on values of order one.
* The critic kernel's ``bf16`` form (its plain version here) computes the
  autograd route's bf16 gradient: within 1e-4 of each tensor's largest
  entry, the kernel's tolerance for float32 (the batch is summed in
  another order, and a value summed apart may round to the other bf16
  neighbour); a ``bfloat16`` step on the kernel route takes the reference
  step's update within 1e-3 of each tensor's largest update, as the
  float32 steps do.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_bf16_dots import with_bf16_operands
from ofdmgan_tpu.models import MiniDiscriminator as JMiniCritic
from ofdmgan_tpu.models import MiniGenerator as JMiniGen
from ofdmgan_tpu.models.critic import compute_gradient_penalty as j_gp
from ofdmgan_tpu.models.full_unet import FullDiscriminator as JFullCritic
from ofdmgan_tpu.models.full_unet import FullUNetGenerator as JFullGen
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.models.critic import compute_gradient_penalty
from ofdmgan_tpu_torch.models.full_unet import FullDiscriminator, FullUNetGenerator
from ofdmgan_tpu_torch.ops import critic_kernel
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig, make_draws, synthetic_batch_from_draws
from ofdmgan_tpu_torch.training import wgan_gp
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("module", ["ofdmgan_tpu_torch.verify.golden",
                                    "ofdmgan_tpu_torch.eval.ber",
                                    "ofdmgan_tpu_torch.models.full_unet"])
def test_importing_the_port_turns_tf32_off(module):
    code = (f"import torch\nassert torch.backends.cudnn.allow_tf32\nimport {module}\n"
            "print(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _frames(seed, n, L):
    return np.random.default_rng(seed).standard_normal((n, L, 2)).astype(np.float32)


MODELS = {
    "mini_critic": (lambda: JMiniCritic(), lambda: MiniDiscriminator(), 16, 2),
    "mini_generator": (lambda: JMiniGen(), lambda: MiniGenerator(), 16, 1),
    "mini_residual": (lambda: JMiniGen(input_residual=True),
                      lambda: MiniGenerator(input_residual=True), 16, 1),
    "full_generator": (lambda: JFullGen(frame_length=64, levels=3, base_channels=8),
                       lambda: FullUNetGenerator(frame_length=64, levels=3, base_channels=8),
                       64, 1),
    "full_critic": (lambda: JFullCritic(frame_length=64, levels=3, base_channels=8),
                    lambda: FullDiscriminator(frame_length=64, levels=3, base_channels=8),
                    64, 2),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_forward_rounds_the_operands_as_the_reference(name):
    jmake, tmake, L, n_in = MODELS[name]
    jm = jmake()
    xs = [_frames(5 + i, 16, L) * 0.5 for i in range(n_in)]
    params = jm.init(jax.random.PRNGKey(2), *[jnp.zeros((1, L, 2))] * n_in)
    ref = np.asarray(with_bf16_operands(jm.apply)(params, *xs))
    tm = tmake()
    tm.load_state_dict(from_jax_params(_np(params)))
    with torch.no_grad(), wgan_gp.matmul_precision("bfloat16"):
        got = tm(*map(torch.from_numpy, xs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    # the rounding is visible: the float32 forward is farther away
    assert np.abs(np.asarray(jm.apply(params, *xs)) - ref).max() > 100 * ATOL


@pytest.mark.parametrize("precision", ["bfloat16", "bf16_f32gp"])
def test_bf16_critic_loss_gradients_match_the_reference(precision):
    """The gradient of E[D(fake)] - E[D(real)] + 10 GP with respect to the
    mini critic's parameters, the penalty's second-order terms included:
    under ``bfloat16`` every dot of it and of its derivatives reads rounded
    operands; under ``bf16_f32gp`` the penalty's chain reads float32 ones."""
    jc = JMiniCritic()
    real, fake, cond = (_frames(s, 32, 16) * 0.5 for s in (11, 12, 13))
    params = jc.init(jax.random.PRNGKey(4), *[jnp.zeros((1, 16, 2))] * 2)
    key = jax.random.PRNGKey(9)

    def wasserstein(p):
        return jnp.mean(jc.apply(p, fake, cond)) - jnp.mean(jc.apply(p, real, cond))

    def penalty(p):
        return 10.0 * j_gp(jc.apply, p, real, fake, cond, key)

    g_w = with_bf16_operands(jax.grad(wasserstein))(params)
    gp_grad = jax.grad(penalty)
    g_gp = with_bf16_operands(gp_grad)(params) if precision == "bfloat16" else gp_grad(params)
    want = flatten_tree(_np(jax.tree_util.tree_map(jnp.add, g_w, g_gp)))

    alpha = torch.from_numpy(np.array(jax.random.uniform(key, (32, 1, 1)))[:, 0, 0])
    tc = MiniDiscriminator()
    tc.load_state_dict(from_jax_params(_np(params)))
    r, f, c = map(torch.from_numpy, (real, fake, cond))
    with wgan_gp.matmul_precision(precision):
        w = tc(f, c).mean() - tc(r, c).mean()
        with wgan_gp.gp_precision(precision):
            gp = compute_gradient_penalty(tc, r, f, c, alpha)
        grads = torch.autograd.grad(w + 10.0 * gp, list(tc.parameters()))
    for p, g in zip(tc.parameters(), grads):
        p.data = g
    got = flatten_tree(to_jax_params(tc))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=RTOL * np.abs(v).max(), err_msg=k)


@pytest.mark.parametrize("b", [64, 1000])
def test_the_critic_kernel_computes_the_bf16_autograd_gradient(b):
    torch.manual_seed(1)
    critic, gen = MiniDiscriminator(), MiniGenerator()
    g = torch.Generator().manual_seed(b)
    clean = torch.randn(b, 16, 2, generator=g)
    noisy = clean + 0.3 * torch.randn(b, 16, 2, generator=g)
    alpha = torch.rand(b, generator=g)
    with torch.no_grad():
        fake = gen(noisy)
    grads, aux = critic_kernel.critic_grad(critic, clean, fake, noisy, alpha, 10.0, bf16=True)
    f32, _ = critic_kernel.critic_grad(critic, clean, fake, noisy, alpha, 10.0)
    with wgan_gp.matmul_precision("bfloat16"):
        loss, want_aux = wgan_gp.critic_loss_fn(critic, lambda x: fake,
                                                {"noisy": noisy, "clean": clean}, alpha,
                                                wgan_gp.LossConfig())
        want = torch.autograd.grad(loss, list(critic.parameters()))
    for (name, _), w in zip(critic.named_parameters(), want):
        scale = float(w.abs().max())
        torch.testing.assert_close(grads[name], w, rtol=0, atol=1e-4 * scale + 1e-9)
        if name.endswith("weight"):   # the rounding is visible
            assert float((f32[name] - w).abs().max()) > 1e-3 * scale
    for k, v in want_aux.items():
        torch.testing.assert_close(aux[k], v, rtol=1e-4, atol=1e-5)


def test_a_bf16_kernel_step_takes_the_reference_step():
    steps = []
    for reference in (False, True):
        torch.manual_seed(2)
        g, d = MiniGenerator(), MiniDiscriminator()
        steps.append(wgan_gp.TrainStep(g, d, make_adam(g.parameters(), 2e-4),
                                       make_adam(d.parameters(), 2e-4), DatagenConfig(),
                                       wgan_gp.LossConfig(), 32, reference=reference,
                                       matmul_precision="bfloat16"))
    assert [s.critic_route for s in steps] == ["kernel", "plain"]
    start = [p.detach().clone() for p in [*steps[0].generator.parameters(),
                                          *steps[0].critic.parameters()]]
    for seed in (0, 1):   # Adam's first step is a sign: compare the second
        gen = torch.Generator().manual_seed(seed)
        batch = synthetic_batch_from_draws(make_draws(gen, 32, 16), DatagenConfig())
        alphas = [torch.rand(32, generator=gen) for _ in range(5)]
        for s in steps:
            s.run(batch, alphas)
    kernel, ref = ([p.detach() for p in [*s.generator.parameters(), *s.critic.parameters()]]
                   for s in steps)
    for p0, a, b in zip(start, kernel, ref):
        assert float((a - b).abs().max()) <= 1e-3 * float((b - p0).abs().max()) + 1e-9

