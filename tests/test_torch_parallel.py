"""The port's data-parallel step and GPipe pipeline against the JAX package's.

Both sides start from the same flax-initialised weights. The JAX side runs
``make_sharded_train_step`` on two of the conftest's virtual CPU devices
and ``make_pp_supervised_train_step`` on a ``{pp: 2}`` mesh; the port runs
two gloo ranks (``tests/torch_parallel_ranks.py``), spawned once for the
module. Each replica's draws are rebuilt from the JAX key each replica
folds in (``jax.random.fold_in(key, i)``, ``mesh.py:56-59``) and the step's
splits (``wgan_gp.py:315, 333``); the pipeline's batch from its key.
Tolerances: the data-parallel step as the one-step bounds of
``tests/test_torch_train_step.py`` (parameters atol 2e-6, metrics and Adam
moments rtol 1e-5: a mean of two replicas' float32 gradients, summed in the
same order on both sides); the pipeline as ``tests/test_pipeline.py:56-76``
(SGD 1e-2, parameters atol 1e-6, loss rtol 1e-5), against JAX and against
the port's single-device supervised update.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.models.full_unet import FullUNetGenerator as JFullGen
from ofdmgan_tpu.parallel import make_mesh as j_make_mesh
from ofdmgan_tpu.parallel import make_pp_supervised_train_step as j_pp_step
from ofdmgan_tpu.parallel import make_sharded_train_step as j_sharded_step
from ofdmgan_tpu.parallel import replicate_state as j_replicate_state
from ofdmgan_tpu.signal import DatagenConfig as JDatagenConfig
from ofdmgan_tpu.signal import synthetic_batch as j_synthetic_batch
from ofdmgan_tpu.training import TrainState
from ofdmgan_tpu.training import make_adam as j_make_adam
from ofdmgan_tpu.training.wgan_gp import LossConfig as JLossConfig
from ofdmgan_tpu_torch.models.full_unet import FullUNetGenerator
from ofdmgan_tpu_torch.parallel import distributed
from ofdmgan_tpu_torch.parallel.pipeline import make_pp_trainstate_step, unet_stage_fns
from ofdmgan_tpu_torch.signal.datagen import DatagenConfig
from ofdmgan_tpu_torch.training.trainer import Trainer, build_models
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from ofdmgan_tpu_torch.config import Config
from torch_parallel_ranks import dp_and_pp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KEY = jax.random.PRNGKey(0)
B, LR, N_CRITIC = 32, 2e-4, 2
PP_B, PP_M, PP_LR, L = 16, 4, 1e-2, 64
LAUNCH_TIMEOUT_S = 120


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_dp():
    """Each replica's draws (the port's inputs) and a function that runs the
    JAX data-parallel step on {dp: 2}."""
    mesh = j_make_mesh({"dp": 2}, devices=jax.devices()[:2])
    jdg = JDatagenConfig.make(frame_length=16, snr_range=(0, 30))
    x0 = jnp.zeros((1, 16, 2))
    jg, jc = JGen(), JCritic()
    pg, pd = jg.init(KEY, x0), jc.init(KEY, x0, x0)
    tx_g, tx_d = j_make_adam(LR), j_make_adam(LR)
    state = j_replicate_state(TrainState.create(pg, pd, tx_g, tx_d), mesh)
    step = j_sharded_step(jg.apply, jc.apply, tx_g, tx_d, jdg, JLossConfig(n_critic=N_CRITIC),
                          global_batch_size=B, mesh=mesh, donate=False)
    key = jax.random.fold_in(KEY, 100)

    def run():
        new, metrics = step(state, key)
        return jax.device_get(new), {k: float(v) for k, v in metrics.items()}

    @jax.jit
    def replica_draws(i):
        k_data, k_crit, _ = jax.random.split(jax.random.fold_in(key, i), 3)
        batch = j_synthetic_batch(k_data, B // 2, jdg)
        alphas = [jax.random.uniform(k, (B // 2, 1, 1), jnp.float32)[:, 0, 0]
                  for k in jax.random.split(k_crit, N_CRITIC)]
        return {k: batch[k] for k in ("noisy", "clean")}, alphas

    draws = [_np(replica_draws(i)) for i in range(2)]
    return ({"pg": _np(pg), "pd": _np(pd), "draws": draws, "lr": LR, "n_critic": N_CRITIC,
             "batch": B}, run)


def _jax_pp():
    """The pipeline's batch (the port's input) and a function that runs the
    JAX pipelined SGD update. The port's runs with and
    without remat are both held against it: remat changes what is kept for
    the backward, not the function (``tests/test_pipeline.py`` holds JAX's
    remat run to the same single-device update), and a second compile of
    the JAX pipeline would double the fixture's time."""
    gen = JFullGen(frame_length=L, levels=3, base_channels=8)
    cfg = JDatagenConfig.make(frame_length=L, snr_range=(0, 30), nonlinear=True)
    params = gen.init(KEY, jnp.zeros((1, L, 2)))
    tx = optax.sgd(PP_LR)
    mesh = j_make_mesh({"pp": 2}, devices=jax.devices()[:2])
    key = jax.random.PRNGKey(5)
    step = j_pp_step(gen, tx, cfg, global_batch_size=PP_B, microbatches=PP_M, mesh=mesh)

    def run():
        (new, _), m = step((params, tx.init(params)), key)
        return jax.device_get(new), float(m["rec_loss"])

    batch = jax.jit(lambda k: j_synthetic_batch(k, PP_B, cfg))(key)
    return ({"pg": _np(params), "lr": PP_LR, "batch": PP_B, "microbatches": PP_M,
             "draws": {k: np.array(batch[k]) for k in ("noisy", "clean")}}, run)


@pytest.fixture(scope="module")
def runs():
    # the ranks need only the inputs: they run while the two JAX steps
    # compile in threads (XLA compiles outside the GIL)
    (dp_in, dp_run), (pp_in, pp_run) = _jax_dp(), _jax_pp()
    with ThreadPoolExecutor(3) as pool:
        ranks = pool.submit(distributed.launch, dp_and_pp, 2, (dp_in, pp_in), threads=1,
                            timeout_s=LAUNCH_TIMEOUT_S)
        dp_fut, pp_fut = pool.submit(dp_run), pool.submit(pp_run)
        (j_dp, j_dp_metrics), j_pp, ranks = dp_fut.result(), pp_fut.result(), ranks.result()
    return {"dp_in": dp_in, "j_dp": j_dp, "j_dp_metrics": j_dp_metrics, "pp_in": pp_in,
            "j_pp": j_pp, "ranks": ranks}


@pytest.mark.parametrize("reference", [False, True], ids=["kernel_route", "reference_route"])
def test_data_parallel_step_matches_jax(runs, reference):
    j_state, jm = runs["j_dp"], runs["j_dp_metrics"]
    r0, r1 = (r[("dp", reference)] for r in runs["ranks"])
    assert r0["routes"] == (("plain", "plain") if reference else ("kernel", "kernel"))
    assert r0["local_batch"] == B // 2
    for tag, tree in (("params_g", j_state.params_g), ("params_d", j_state.params_d)):
        ref = flatten_tree(_np(tree))
        for k in ref:
            assert np.array_equal(r0[tag][k], r1[tag][k]), k   # replicas in lockstep
            np.testing.assert_allclose(r0[tag][k], ref[k], rtol=0, atol=2e-6, err_msg=k)
    for name, ref in jm.items():
        np.testing.assert_allclose(r0["metrics"][name], ref, rtol=1e-5, atol=1e-6, err_msg=name)
    for tag, jopt in (("g", j_state.opt_g), ("d", j_state.opt_d)):
        mu, nu = from_jax_params(_np(jopt[0].mu)), from_jax_params(_np(jopt[0].nu))
        for name in mu:
            for got, ref in zip(r0["moments"][f"{tag}.{name}"], (mu[name], nu[name])):
                ref = ref.numpy()
                np.testing.assert_allclose(got, ref, rtol=1e-5,
                                           atol=1e-5 * float(np.abs(ref).max()) + 1e-12,
                                           err_msg=f"{tag}.{name}")


@pytest.mark.parametrize("remat", [False, True])
def test_pipeline_matches_jax_and_the_single_device_update(runs, remat):
    pp_in = runs["pp_in"]
    j_params, j_loss = runs["j_pp"]
    ref_jax = flatten_tree(_np(j_params))
    # the port's single-device supervised SGD update on the same batch
    g = FullUNetGenerator(frame_length=L, levels=3, base_channels=8)
    g.load_state_dict(from_jax_params(pp_in["pg"]))
    batch = {k: torch.from_numpy(v) for k, v in pp_in["draws"].items()}
    loss = (g(batch["noisy"]) - batch["clean"]).abs().mean()
    loss.backward()
    loss = float(loss.detach())
    torch.optim.SGD(g.parameters(), PP_LR).step()
    ref_single = flatten_tree(to_jax_params(g))
    for r in runs["ranks"]:
        got = r[("pp", remat)]
        np.testing.assert_allclose(got["rec_loss"], j_loss, rtol=1e-5)
        np.testing.assert_allclose(got["rec_loss"], loss, rtol=1e-5)
        for k in ref_jax:
            np.testing.assert_allclose(got["params_g"][k], ref_jax[k], atol=1e-6, err_msg=k)
            np.testing.assert_allclose(got["params_g"][k], ref_single[k], atol=1e-6, err_msg=k)


def test_every_rank_reads_rank_zeros_scalar(runs):
    assert [r["scalar"] for r in runs["ranks"]] == [0.5, 0.5]


def test_stage_composition_matches_the_forward():
    g = FullUNetGenerator(frame_length=L, levels=3, base_channels=8)
    stages, width = unet_stage_fns(g, L)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, L, 2)).astype(np.float32))
    buf = torch.nn.functional.pad(x.reshape(4, -1), (0, width - 2 * L))
    y = stages[1](stages[0](buf))[:, :2 * L].reshape(4, L, 2)
    torch.testing.assert_close(y, g(x), rtol=0, atol=1e-6)


def test_a_pipeline_needs_two_stages(runs):
    msg = runs["ranks"][0]["pp_refusal"]
    assert "pp=1" in msg and "2 stages" in msg


def test_the_pipeline_refuses_an_adversarial_configuration():
    g = FullUNetGenerator(frame_length=L, levels=3, base_channels=8)
    opt = torch.optim.SGD(g.parameters(), 1e-2)
    for loss_cfg in (LossConfig(), LossConfig(n_critic=0, adv_weight=0.5),
                     LossConfig(n_critic=2, adv_weight=0.0)):
        with pytest.raises(ValueError, match="SUPERVISED path only"):
            make_pp_trainstate_step(g, opt, DatagenConfig(frame_length=L), loss_cfg, 16, 4,
                                    mesh=None)


def _full_trainer(**kw):
    cfg = Config(frame_length=L, export_after_training=False)
    g, d = build_models(cfg, "full", 0)
    return Trainer(cfg, device="cpu", generator=g, discriminator=d, **kw)


@pytest.mark.parametrize("kw, match", [
    (dict(strategy="gspmd", tensor_parallel=2, seq_parallel=2), "sp x tp"),
    (dict(strategy="gspmd", remat=True), "does not support remat"),
    (dict(strategy="shard_map", tensor_parallel=2), "require strategy='gspmd'"),
    (dict(strategy="shard_map", seq_parallel=2), "require strategy='gspmd'"),
    (dict(strategy="pp", fused_decoder=True), "strategy='pp' does not support fused_decoder"),
    (dict(strategy="ring"), "unknown strategy"),
    (dict(data_parallel=2, remat=True), "drop --remat with dp>1"),
])
def test_the_reference_refusals_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        _full_trainer(**kw)


def test_the_mini_pair_refuses_tensor_parallelism_and_the_pipeline():
    cfg = Config(export_after_training=False)
    with pytest.raises(ValueError, match="full U-Net family"):
        Trainer(cfg, device="cpu", strategy="gspmd", tensor_parallel=2)
    with pytest.raises(ValueError, match="full U-Net family"):
        Trainer(cfg, device="cpu", strategy="pp")


def test_data_parallel_without_ranks_raises():
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        Trainer(Config(export_after_training=False), device="cpu", data_parallel=2)
