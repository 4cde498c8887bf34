"""The critic-gradient kernel's plain version against the Pallas TPU kernel
(in interpret mode, as tests/test_pallas_critic.py:53 runs it) and against
``jax.grad`` of ``critic_loss_fn``, with the same interpolation uniforms;
and the CUDA kernel's conv-form chain (only the taps inside the frame, the
candidate-only penalty, the bias sums), written out in numpy, against both.

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
    return ck.critic_grad(s["tc"], clean, fake, noisy, torch.from_numpy(s["eps"]), 10.0)


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


def _conv_taps(l_in, l_out):
    """(k, t_out, t_in) of every tap inside the frame: t_in = 2 t_out - 1 + k,
    so the padding tap t_in = -1 is left out."""
    return [(k, t, 2 * t - 1 + k) for t in range(l_out) for k in range(3)
            if 0 <= 2 * t - 1 + k < l_in]


def conv_form_grads(params, clean, fake, noisy, alpha, gp_weight, slope=0.2):
    """The kernel's chain in float64 numpy, tap by tap (csrc/critic_grad.cu):
    torch-layout parameter gradients in ``named_parameters()`` order and the
    metrics."""
    w1, b1, w2, b2 = (params[k] for k in ("conv1.weight", "conv1.bias", "conv2.weight",
                                          "conv2.bias"))
    wd, bd = params["dense.weight"][0], params["dense.bias"][0]
    b = clean.shape[0]
    a = alpha[:, None, None]
    h = np.stack([np.concatenate([x, noisy], -1)
                  for x in (clean, fake, a * clean + (1 - a) * fake)])   # [3, B, 16, 4]
    t1, t2 = _conv_taps(16, 8), _conv_taps(8, 4)

    def fwd(x, w, taps, l_out):
        y = np.zeros(x.shape[:-2] + (l_out, w.shape[0]))
        for k, t, p in taps:
            y[..., t, :] += x[..., p, :] @ w[:, :, k].T
        return y

    def bwd(d, w, taps, l_in):
        x = np.zeros(d.shape[:-2] + (l_in, w.shape[1]))
        for k, t, p in taps:
            x[..., p, :] += d[..., t, :] @ w[:, :, k]
        return x

    def wgrad(d, x, taps, w):
        g = np.zeros_like(w)
        for k, t, p in taps:
            dt, xp = d[..., t, :], x[..., p, :]
            g[:, :, k] += dt.reshape(-1, dt.shape[-1]).T @ xp.reshape(-1, xp.shape[-1])
        return g

    def mask(z):
        return np.where(z > 0, 1.0, slope)

    z1 = fwd(h, w1, t1, 8) + b1
    m1 = mask(z1)
    x1 = z1 * m1
    z2 = fwd(x1, w2, t2, 4) + b2
    m2 = mask(z2)
    x2 = z2 * m2
    y = x2.sum(-2) @ wd                                   # [3, B], without the bias
    dy = np.array([-1.0 / b, 1.0 / b])[:, None, None, None]
    dz2 = dy * wd * m2[:2]
    dz1 = bwd(dz2, w2, t2, 8) * m1[:2]
    g_w1, g_w2 = wgrad(dz1, h[:2], t1, w1), wgrad(dz2, x1[:2], t2, w2)
    g_wd = (dy[..., 0] * x2[:2].sum(-2)).sum((0, 1))
    e2 = m2[2] * wd
    e1 = bwd(e2, w2, t2, 8) * m1[2]
    g = bwd(e1, w1, t1, 16)[..., :2]                      # dy/dh0 on the candidate
    n = np.sqrt((g ** 2).sum((1, 2)) + 1e-12)
    c = np.concatenate([(2 * gp_weight / b * (n - 1) / n)[:, None, None] * g,
                        np.zeros_like(g)], -1)
    c1 = fwd(c, w1, t1, 8) * m1[2]
    g_w1 += wgrad(e1, c, t1, w1)
    g_w2 += wgrad(e2, c1, t2, w2)
    g_wd += (fwd(c1, w2, t2, 4) * m2[2]).sum((0, 1))
    grads = {"conv1.weight": g_w1, "conv1.bias": dz1.sum((0, 1, 2)),
             "conv2.weight": g_w2, "conv2.bias": dz2.sum((0, 1, 2)),
             "dense.weight": g_wd[None, :], "dense.bias": np.zeros(1)}
    d_real, d_fake, gp = y[0].mean() + bd, y[1].mean() + bd, ((n - 1) ** 2).mean()
    aux = {"d_loss": d_fake - d_real + gp_weight * gp, "wasserstein_distance": d_real - d_fake,
           "gradient_penalty": gp, "d_real_mean": d_real, "d_fake_mean": d_fake}
    return grads, aux


def _numpy_inputs(s):
    noisy, clean = torch.from_numpy(s["noisy"]), torch.from_numpy(s["clean"])
    with torch.no_grad():
        fake = s["tg"](noisy).numpy().astype(np.float64)
    params = {n: p.detach().numpy().astype(np.float64) for n, p in s["tc"].named_parameters()}
    return params, s["clean"].astype(np.float64), fake, s["noisy"].astype(np.float64), \
        s["eps"].astype(np.float64)


@pytest.mark.parametrize("b", [1, 40])
def test_conv_form_chain_matches_jax_grad(b):
    s = _setup(b, seed=6)
    batch = {"noisy": s["noisy"], "clean": s["clean"]}
    (_, ref_aux), ref_grads = jax.value_and_grad(j_critic_loss_fn, has_aux=True)(
        s["pd"], s["pg"], s["jg"].apply, s["jc"].apply, batch, s["k_gp"], JLossConfig())
    grads, aux = conv_form_grads(*_numpy_inputs(s), 10.0)
    _compare({n: torch.from_numpy(g) for n, g in grads.items()}, aux, ref_grads, ref_aux)


@pytest.mark.parametrize("b", [1, 40])
def test_critic_grad_matches_conv_form_chain(b):
    """The wrapper's CPU path (the packed dense version) against the
    kernel's tap-by-tap chain, B = 1 included."""
    s = _setup(b, seed=7)
    grads, aux = _port_grads(s)
    ref, ref_aux = conv_form_grads(*_numpy_inputs(s), 10.0)
    assert list(grads) == [n for n, _ in s["tc"].named_parameters()]
    for n, r in ref.items():
        np.testing.assert_allclose(grads[n].numpy(), r, err_msg=n, **TOL)
    for n in METRICS:
        np.testing.assert_allclose(float(aux[n]), ref_aux[n], err_msg=n, **TOL)


@pytest.mark.parametrize("b", [1, 5])
def test_critic_grad_matches_jax_grad_at_small_batches(b):
    s = _setup(b, seed=8)
    batch = {"noisy": s["noisy"], "clean": s["clean"]}
    (_, ref_aux), ref_grads = jax.value_and_grad(j_critic_loss_fn, has_aux=True)(
        s["pd"], s["pg"], s["jg"].apply, s["jc"].apply, batch, s["k_gp"], JLossConfig())
    _compare(*_port_grads(s), ref_grads, ref_aux)


def test_kernel_output_buffer_layout():
    """The kernel's one output buffer splits into the parameters' gradients in
    ``named_parameters()`` order, then the five metrics, as views."""
    critic = MiniDiscriminator()
    out = torch.arange(526, dtype=torch.float32)
    grads, aux = ck._split(out)
    off = 0
    for (name, p), (gname, g) in zip(critic.named_parameters(), grads.items()):
        assert gname == name and g.shape == p.shape and g._base is out
        assert torch.equal(g.reshape(-1), torch.arange(off, off + p.numel(), dtype=torch.float32))
        off += p.numel()
    assert off == 521 and tuple(aux) == METRICS
    assert [float(v) for v in aux.values()] == [521.0, 522.0, 523.0, 524.0, 525.0]


def test_covers_the_mini_critic_at_16_samples():
    assert ck.covers(MiniDiscriminator(), 16)
    assert not ck.covers(MiniDiscriminator(), 32)
    assert not ck.covers(MiniDiscriminator(conv1_channels=4), 16)
    assert not ck.covers(MiniDiscriminator(conv2_channels=8), 16)


@pytest.mark.parametrize("L", [8, 32])
def test_other_frame_lengths_raise_a_value_error(L):
    """Not a shape error from inside the dense products."""
    critic = MiniDiscriminator()
    x = torch.zeros(4, L, 2)
    alpha = torch.rand(4)
    for fn in (ck.critic_grad_packed, ck.critic_grad, ck.prepare):
        with pytest.raises(ValueError, match="frames of shape"):
            fn(critic, x, x, x, alpha, 10.0)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__6208_14_critic_grad_cu_c7775540\
18critic_grad_kernelILi2ELb0EfEEvNS_4ArgsIT1_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__6208_14_critic_grad_cu_c7775540\
18critic_grad_kernelILi2ELb0EfEEvNS_4ArgsIT1_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 2112 bytes smem
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__6208_14_critic_grad_cu_c7775540\
18critic_grad_kernelILi1ELb1E13__nv_bfloat16EEvNS_4ArgsIT1_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__6208_14_critic_grad_cu_c7775540\
18critic_grad_kernelILi1ELb1E13__nv_bfloat16EEvNS_4ArgsIT1_EE
    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 8 bytes cumulative stack size, 2112 bytes smem
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__b3cd_9_parent_cu_f225ee87\
18critic_grad_kernelILb0EfEEvNS_4ArgsIT0_EE' for 'sm_90a'
ptxas info    : Used 154 registers, used 1 barriers, 15968 bytes smem
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__b3cd_9_parent_cu_f225ee87\
22critic_grad_sum_kernelENS_6CommonE' for 'sm_90a'
ptxas info    : Used 20 registers, used 1 barriers, 1024 bytes smem
"""


def test_ptxas_summary_reads_each_instantiation():
    """Registers and spilled bytes by frames a warp, matmul precision and
    storage; a kernel without a frames parameter counts as one frame a warp;
    the second stage is left out."""
    assert ck.ptxas_summary(PTXAS_LOG) == {
        "frames2_f32_f32": {"spill_bytes": 0, "registers": 255},
        "frames1_bf16_bf16": {"spill_bytes": 16, "registers": 255},
        "frames1_f32_f32": {"registers": 154},
    }
    assert ck.ptxas_summary("") == {}
