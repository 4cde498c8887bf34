"""The port's outer step with the full U-Net pair against the JAX step, the
step's routes and numerics settings, and ``--model full`` through the CLI.

The step: a three-level, base-4 pair at L = 32, batch 8, n_critic 5, both
sides on the same flax-initialised weights, warmed up by three JAX steps
whose parameters and Adam states are then copied into the port (from a
fresh Adam state a gradient that is zero up to rounding would become a full
step of either sign). One more step on each side, the port's batch and
gradient-penalty uniforms rebuilt from the JAX step's key splits
(wgan_gp.py:315,333, critic.py:95). Tolerances as for the mini step
(tests/test_torch_train_step.py), in float32 with lr = 2e-4: parameters
atol 2e-6 (a hundredth of one update), metrics rtol 1e-5 and atol 1e-6,
Adam moments rtol 1e-5 of each tensor's largest entry.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JMiniCritic
from ofdmgan_tpu.models.full_unet import FullDiscriminator as JCritic
from ofdmgan_tpu.models.full_unet import FullUNetGenerator as JGen
from ofdmgan_tpu.models.unet_infer import make_unet_infer_apply as j_infer_apply
from ofdmgan_tpu.signal import DatagenConfig as JDatagenConfig
from ofdmgan_tpu.signal import synthetic_batch as j_synthetic_batch
from ofdmgan_tpu.training import TrainState
from ofdmgan_tpu.training import make_adam as j_make_adam
from ofdmgan_tpu.training import make_train_step
from ofdmgan_tpu.training.wgan_gp import LossConfig as JLossConfig
from ofdmgan_tpu.utils.params_io import load_params_tree as j_load
from ofdmgan_tpu_torch import train as train_cli
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.models.full_unet import FullDiscriminator, FullUNetGenerator
from ofdmgan_tpu_torch.models.unet_infer import make_unet_infer_apply
from ofdmgan_tpu_torch.ops.bf16_dots import round_bf16
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig, make_draws, synthetic_batch_from_draws
from ofdmgan_tpu_torch.training import wgan_gp
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.training.trainer import Trainer, build_models
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from jax_bf16_dots import with_bf16_operands
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LEVELS, BASE, L, B, LR, N_CRITIC = 3, 4, 32, 8, 2e-4, 5
KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class FullPair:
    """A JAX step and a port step with the full pair on the same weights;
    ``fused`` trains both through the fused decoder."""

    def __init__(self, fused):
        jdg = JDatagenConfig.make(frame_length=L, snr_range=(0, 30))
        x0 = jnp.zeros((1, L, 2))
        jg = JGen(frame_length=L, levels=LEVELS, base_channels=BASE)
        jc = JCritic(frame_length=L, levels=LEVELS, base_channels=BASE)
        pg, pd = jax.jit(jg.init)(KEY, x0), jax.jit(jc.init)(KEY, x0, x0)
        tx_g, tx_d = j_make_adam(LR, (0.0, 0.9)), j_make_adam(LR, (0.0, 0.9))
        self.jstate = TrainState.create(pg, pd, tx_g, tx_d)
        gen_apply = (j_infer_apply(levels=LEVELS, act_dtype=jnp.float32, fused_decoder=True)
                     if fused else jg.apply)
        self.jstep = make_train_step(gen_apply, jc.apply, tx_g, tx_d, jdg,
                                     JLossConfig(n_critic=N_CRITIC), batch_size=B, donate=False)
        self.g = FullUNetGenerator(frame_length=L, levels=LEVELS, base_channels=BASE)
        self.d = FullDiscriminator(frame_length=L, levels=LEVELS, base_channels=BASE)
        self.opt_g = make_adam(self.g.parameters(), LR, (0.0, 0.9))
        self.opt_d = make_adam(self.d.parameters(), LR, (0.0, 0.9))
        fwd = (make_unet_infer_apply(levels=LEVELS, act_dtype=torch.float32)
               if fused else None)
        self.tstep = TrainStep(self.g, self.d, self.opt_g, self.opt_d,
                               DatagenConfig(frame_length=L), LossConfig(n_critic=N_CRITIC), B,
                               gen_forward=fwd)

        @jax.jit
        def draws(key):
            k_data, k_crit, _ = jax.random.split(key, 3)
            alphas = [jax.random.uniform(k, (B, 1, 1), jnp.float32)[:, 0, 0]
                      for k in jax.random.split(k_crit, N_CRITIC)]
            return j_synthetic_batch(k_data, B, jdg), alphas

        self.draws = draws

    def warm_up(self, n):
        """``n`` JAX steps, then the port's parameters, Adam moments and step
        counts set to the JAX side's."""
        for i in range(n):
            self.jstate, _ = self.jstep(self.jstate, jax.random.fold_in(KEY, 100 + i))
        count = int(self.jstate.step)
        for mod, opt, params, jopt, updates in (
                (self.g, self.opt_g, self.jstate.params_g, self.jstate.opt_g, count),
                (self.d, self.opt_d, self.jstate.params_d, self.jstate.opt_d, count * N_CRITIC)):
            mod.load_state_dict(from_jax_params(_np(params)))
            mu, nu = from_jax_params(_np(jopt[0].mu)), from_jax_params(_np(jopt[0].nu))
            assert int(jopt[0].count) == updates
            for name, param in mod.named_parameters():
                opt.opt.state[param] = {"step": torch.tensor(float(updates)),
                                        "exp_avg": mu[name].clone(),
                                        "exp_avg_sq": nu[name].clone()}

    def step(self, i):
        key = jax.random.fold_in(KEY, 100 + i)
        self.jstate, jm = self.jstep(self.jstate, key)
        batch, alphas = self.draws(key)
        batch = {k: torch.from_numpy(np.array(batch[k])) for k in ("noisy", "clean")}
        return jm, self.tstep.run(batch, [torch.from_numpy(np.array(a)) for a in alphas])


@pytest.mark.parametrize("fused", [False, True])
def test_one_full_step_matches_jax(fused):
    p = FullPair(fused)
    assert (p.tstep.datagen_route, p.tstep.critic_route) == ("kernel", "plain")
    p.warm_up(3)
    jm, tm = p.step(3)
    for name, ref in jm.items():
        np.testing.assert_allclose(float(tm[name]), float(ref), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for mod, opt, jp, jopt in ((p.g, p.opt_g, p.jstate.params_g, p.jstate.opt_g),
                               (p.d, p.opt_d, p.jstate.params_d, p.jstate.opt_d)):
        ref = flatten_tree(_np(jp))
        got = flatten_tree(to_jax_params(mod))
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-6, err_msg=k)
        for slot, jtree in (("exp_avg", jopt[0].mu), ("exp_avg_sq", jopt[0].nu)):
            ref = from_jax_params(_np(jtree))
            for name, param in mod.named_parameters():
                np.testing.assert_allclose(opt.opt.state[param][slot].numpy(),
                                           ref[name].numpy(), rtol=1e-5,
                                           atol=1e-5 * float(ref[name].abs().max()) + 1e-12,
                                           err_msg=f"{name} {slot}")


def _step(family, act_dtype=None, precision="float32", frame_length=16):
    if family == "full":
        g, d = (FullUNetGenerator(frame_length=frame_length, levels=2, base_channels=4),
                FullDiscriminator(frame_length=frame_length, levels=2, base_channels=4))
    else:
        g, d = MiniGenerator(act_dtype=act_dtype), MiniDiscriminator(act_dtype=act_dtype)
    return TrainStep(g, d, make_adam(g.parameters(), LR), make_adam(d.parameters(), LR),
                     DatagenConfig(frame_length=frame_length), LossConfig(), B,
                     act_dtype=act_dtype, matmul_precision=precision)


@pytest.mark.parametrize("family,act_dtype,precision,routes", [
    ("mini", None, "float32", ("kernel", "kernel")),
    ("mini", "bfloat16", "float32", ("kernel", "plain")),
    ("mini", "float8_e4m3fn", "float32", ("kernel", "plain")),
    ("mini", "float8_e5m2", "float32", ("kernel", "plain")),
    ("mini", None, "tensorfloat32", ("kernel", "plain")),
    ("mini", None, "bfloat16", ("kernel", "kernel")),
    ("mini", None, "bf16_tf32gp", ("kernel", "plain")),
    ("mini", None, "bf16_f32gp", ("kernel", "plain")),
    ("full", None, "float32", ("kernel", "plain")),
    ("full", "bfloat16", "float32", ("kernel", "plain")),
])
def test_routes_for_each_family_act_dtype_and_precision(family, act_dtype, precision, routes):
    """The critic kernel computes the mini critic at float32 or bfloat16
    precision: with a storage format or another precision the critic route
    is plain; the datagen route does not depend on either (the batch is cast
    after it)."""
    step = _step(family, act_dtype, precision)
    assert (step.datagen_route, step.critic_route) == routes


def test_the_full_family_routes_at_its_frame_length():
    step = _step("full", frame_length=1024)
    assert (step.datagen_route, step.critic_route) == ("kernel", "plain")
    step.reference = True
    assert (step.datagen_route, step.critic_route) == ("plain", "plain")


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("start", [(False, False), (True, False), (False, True)])
def test_a_tensorfloat32_step_restores_the_tf32_flags(start, monkeypatch):
    step = _step("mini", precision="tensorfloat32")
    seen = []
    forward = step.critic.forward
    monkeypatch.setattr(step.critic, "forward", lambda *a: seen.append(_flags()) or forward(*a))
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = start
    try:
        metrics = step(torch.Generator().manual_seed(0))
        after = _flags()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert after == start
    assert seen and set(seen) == {(True, True)}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.parametrize("precision,rounded", [
    ("bfloat16", [True] * 3),
    ("bf16_tf32gp", [True, True, False]),
    ("bf16_f32gp", [True, True, False]),
])
def test_bf16_modes_keep_the_penalty_where_the_reference_does(precision, rounded):
    """The critic's conv2 in one critic update (real, fake, the penalty's
    interpolate): float32 outputs, each the conv of bf16-rounded operands
    under ``bfloat16``, the penalty's on unrounded operands in the mixed
    modes (reference wgan_gp.py:119-133)."""
    step = _step("mini", precision=precision)
    step.reference = True   # the autograd critic (bfloat16 also routes to the kernel)
    step.loss_cfg = LossConfig(n_critic=1)
    seen = []
    step.critic.conv2.register_forward_hook(lambda m, i, o: seen.append(
        [t.detach().clone() for t in (i[0], m.weight, m.bias, o)]))
    gen = torch.Generator().manual_seed(1)
    batch = synthetic_batch_from_draws(make_draws(gen, B, 16), step.dg_cfg)
    metrics = step.run(batch, [torch.rand(B, generator=gen)])
    got = []
    for x, w, bias, out in seen[:3]:
        assert out.dtype == torch.float32
        full = torch.nn.functional.conv1d(x, w, bias, 2, 1)
        bf16 = torch.nn.functional.conv1d(round_bf16(x), round_bf16(w), bias, 2, 1)
        assert float((bf16 - full).abs().max()) > 1e-4   # the two are told apart
        got.append(bool(torch.allclose(out, bf16, rtol=1e-5, atol=1e-6)))
        assert got[-1] != bool(torch.allclose(out, full, rtol=1e-5, atol=1e-6))
    assert got == rounded
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def test_bf16_precision_critic_stays_within_the_reference_bf16_tolerance():
    """A critic forward under the port's ``bfloat16`` mode against the JAX
    critic with the operands of each dot rounded to bf16, as
    ``jax.default_matmul_precision("bfloat16")`` computes on a TPU (XLA's
    CPU ignores the setting, so ``with_bf16_operands`` rounds them): float32
    outputs, rtol 1e-5 (bf16 products are exact in float32; only the sums'
    order differs)."""
    jc = JMiniCritic()
    x0 = jnp.zeros((1, 16, 2))
    params = jc.init(jax.random.PRNGKey(3), x0, x0)
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((32, 16, 2)).astype(np.float32) for _ in range(2))
    ref = np.asarray(with_bf16_operands(jc.apply)(params, a, b))
    tc = MiniDiscriminator()
    tc.load_state_dict(from_jax_params(_np(params)))
    with torch.no_grad(), wgan_gp.matmul_precision("bfloat16"):
        got = tc(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(jc.apply(params, a, b)) - ref).max() > 1e-3   # bf16 did round


def test_matmul_precision_must_be_a_known_mode():
    with pytest.raises(ValueError):
        _step("mini", precision="highest")
    with pytest.raises(ValueError):
        with wgan_gp.matmul_precision("fp16"):
            pass


def _cli_args(tmp_path, name, *extra):
    return ["--device", "cpu", "--model", "full", "--frame_length", "64", "--batch_size", "4",
            "--samples_per_epoch", "8", "--val_samples", "4", "--epochs", "1",
            "--checkpoint_dir", str(tmp_path / name / "c"), "--log_dir", str(tmp_path / name / "l"),
            "--export_dir", str(tmp_path / name / "e"), *extra]


def test_cli_full_run_checkpoint_loads_in_jax_and_resumes(tmp_path, capsys):
    """``--model full`` at L = 64, batch 4, two outer steps on the CPU: JAX's
    ``params_io`` loads the checkpoint and JAX's generator computes the
    port's forward from it (atol 1e-5); a trainer resumed from the
    checkpoint takes exactly the uninterrupted trainer's next step."""
    trainer = train_cli.main(_cli_args(tmp_path, "run"))
    out = capsys.readouterr().out
    assert "Generator parameters: 3,936,578" in out and "Discriminator parameters: 524,129" in out
    assert "datagen kernel | critic plain | precision float32" in out
    assert trainer.global_step == 2
    ckpt = tmp_path / "run" / "c" / "final_model"
    side = json.loads((ckpt / "trainer_state.json").read_text())
    assert side["config"]["frame_length"] == 64 and side["config"]["full"]["levels"] == 5

    jg = JGen(frame_length=64)
    x = np.random.default_rng(3).standard_normal((2, 64, 2)).astype(np.float32) * 0.5
    with torch.no_grad():
        mine = trainer.generator(torch.from_numpy(x)).numpy()
    for path in (ckpt / "params_g.npz", tmp_path / "run" / "c" / "final_params_g.npz"):
        np.testing.assert_allclose(np.asarray(jax.jit(jg.apply)(j_load(str(path)), x)), mine,
                                   rtol=1e-5, atol=1e-5)
    assert set(flatten_tree(j_load(str(ckpt / "params_d.npz")))) == \
        set(flatten_tree(to_jax_params(trainer.critic)))

    args = train_cli.build_parser().parse_args(_cli_args(tmp_path, "run"))
    cfg = train_cli.config_from_args(args)
    g, d = build_models(cfg, "full", seed=5)
    resumed = Trainer(cfg, samples_per_epoch=8, val_samples=4, device="cpu", seed=5,
                      generator=g, discriminator=d)
    resumed.load_checkpoint(ckpt)
    updates = []
    for t in (trainer, resumed):
        gen = torch.Generator().manual_seed(9)
        batch = synthetic_batch_from_draws(make_draws(gen, 4, 64), t.dg_cfg)
        alphas = [torch.rand(4, generator=gen) for _ in range(t.loss_cfg.n_critic)]
        before = [p.detach().clone() for m in (t.generator, t.critic) for p in m.parameters()]
        t.step.run(batch, alphas)
        updates.append([p.detach() - b for p, b in
                        zip([p for m in (t.generator, t.critic) for p in m.parameters()], before)])
    for want, got in zip(*updates):
        assert torch.equal(got, want)
    assert any(float(u.abs().max()) > 0 for u in updates[0])


@pytest.mark.parametrize("extra,error", [
    (["--residual"], SystemExit),
    (["--qat"], SystemExit),
    (["--rtl_qat"], SystemExit),
    (["--fused_decoder", "--act_dtype", "float8_e4m3fn"], SystemExit),
    (["--quant_bits", "8", "16", "--act_dtype", "bfloat16"], ValueError),
    (["--model", "mini", "--fused_decoder"], SystemExit),
    (["--model", "mini", "--quant_bits", "8", "16"], SystemExit),
])
def test_cli_refuses_what_the_reference_refuses(tmp_path, extra, error):
    with pytest.raises(error) as info:
        train_cli.main(_cli_args(tmp_path, "refused", *extra))
    if error is ValueError:   # the reference's _QuantConv cannot take a bf16 batch either
        assert "the reference cannot run it either" in str(info.value)
    assert not (tmp_path / "refused").exists()


def test_cli_full_defaults_to_1024_samples_and_the_full_section():
    parse = train_cli.build_parser().parse_args
    assert train_cli.config_from_args(parse(["--model", "full"])).frame_length == 1024
    assert train_cli.config_from_args(parse(["--model", "full", "--frame_length", "256"])
                                      ).frame_length == 256
    assert train_cli.config_from_args(parse([])).frame_length == 16


def test_fused_decoder_needs_a_float_full_generator():
    with pytest.raises(ValueError):
        Trainer(device="cpu", fused_decoder=True)
    g, d = build_models(train_cli.config_from_args(
        train_cli.build_parser().parse_args(["--model", "full", "--frame_length", "64"])), "full")
    with pytest.raises(ValueError):
        Trainer(device="cpu", generator=g, discriminator=d, fused_decoder=True,
                act_dtype="float8_e5m2")
    t = Trainer(device="cpu", generator=g, discriminator=d, fused_decoder=True,
                act_dtype="bfloat16")
    assert t.step.gen_forward is not None and t.step.act_dtype == torch.bfloat16


def test_a_failing_datagen_kernel_raises_on_the_full_path(monkeypatch):
    """The full step's batch comes from the datagen kernel's route; a kernel
    that fails is not replaced by the plain datagen."""
    from ofdmgan_tpu_torch.ops import datagen_kernel

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(datagen_kernel, "synthetic_batch", broken)
    step = _step("full", frame_length=32)
    assert step.datagen_route == "kernel"
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        step(torch.Generator().manual_seed(0))
