"""The JAX side of the port's GSPMD trainer legs.

``jax_leg`` warms a JAX GSPMD state up on the conftest's virtual CPU
devices, built as the JAX trainer builds its GSPMD step
(``ofdmgan_tpu/training/trainer.py:254-330``: the training forward with the
fused decoder where asked, ``unet_param_shardings`` under ``tp``, no
``act_dtype``), takes one more step, and returns the leg the port's ranks
take (``tests/torch_parallel_ranks.trainer_legs``: the warmed state and
that step's global draws, rebuilt from its key splits, ``wgan_gp.py:315,
333``) with JAX's warmed and stepped states and metrics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.models.full_unet import FullDiscriminator as JFullCritic
from ofdmgan_tpu.models.full_unet import FullUNetGenerator as JFullGen
from ofdmgan_tpu.models.full_unet import unet_param_shardings as j_unet_param_shardings
from ofdmgan_tpu.models.unet_infer import make_unet_infer_apply as j_infer_apply
from ofdmgan_tpu.parallel import make_mesh as j_make_mesh
from ofdmgan_tpu.parallel.gspmd import make_gspmd_train_step as j_gspmd_step
from ofdmgan_tpu.signal import DatagenConfig as JDatagenConfig
from ofdmgan_tpu.signal import synthetic_batch as j_synthetic_batch
from ofdmgan_tpu.training import make_adam as j_make_adam
from ofdmgan_tpu.training.wgan_gp import LossConfig as JLossConfig
from ofdmgan_tpu_torch.models.full_unet import FullUNetGenerator
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree

KEY = jax.random.PRNGKey(0)
LR, WARM_STEPS = 2e-4, 3
FULL = dict(levels=3, base_channels=8)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_leg(mesh_axes, family, L, batch, n_critic, act_dtype=None, gen=None, fused=False):
    """``gen``: the generator's modes (the mini ``qat``/``rtl_faithful``/
    ``input_residual``, the full ``quant_bits``); ``act_dtype`` the
    trainer's flag, which reaches the mini pair's modules (and would reach
    the fused decoder's apply), never the step."""
    gen = dict(gen or {})
    mesh = j_make_mesh(mesh_axes, devices=jax.devices()[:2])
    x0 = jnp.zeros((1, L, 2))
    if family == "mini":
        jg, jc = JGen(act_dtype=act_dtype, **gen), JCritic(act_dtype=act_dtype)
    else:
        wb, ab = gen.get("quant_bits", (0, 0))
        jg = JFullGen(frame_length=L, weight_bits=wb, act_bits=ab, **FULL)
        jc = JFullCritic(frame_length=L, **FULL)
    gen_apply = (j_infer_apply(levels=FULL["levels"], act_dtype=jnp.float32, fused_decoder=True)
                 if fused else jg.apply)
    jdg = JDatagenConfig.make(frame_length=L)
    tp = mesh_axes.get("tp", 1) > 1
    make_state, step = j_gspmd_step(
        gen_apply, jc.apply, j_make_adam(LR), j_make_adam(LR), jdg,
        JLossConfig(n_critic=n_critic), global_batch_size=batch, mesh=mesh,
        gen_tp_rule=j_unet_param_shardings if tp else None, donate=False)
    state = make_state(jg.init(KEY, x0), jc.init(KEY, x0, x0))
    for i in range(WARM_STEPS):
        state, _ = step(state, jax.random.fold_in(KEY, 100 + i))
    warm = jax.device_get(state)
    key = jax.random.fold_in(KEY, 100 + WARM_STEPS)
    new, metrics = step(state, key)

    @jax.jit
    def draws(key):
        k_data, k_crit, _ = jax.random.split(key, 3)
        b = j_synthetic_batch(k_data, batch, jdg)
        alphas = [jax.random.uniform(k, (batch, 1, 1), jnp.float32)[:, 0, 0]
                  for k in jax.random.split(k_crit, n_critic)]
        return {k: b[k] for k in ("noisy", "clean")}, alphas

    def opt(o):
        return (np_tree(o[0].mu), np_tree(o[0].nu), int(o[0].count))

    leg = {"mesh": mesh_axes, "family": family, "frame_length": L, "batch": batch,
           "n_critic": n_critic, "lr": LR, "pg": np_tree(warm.params_g),
           "pd": np_tree(warm.params_d), "opt_g": opt(warm.opt_g), "opt_d": opt(warm.opt_d),
           "draws": np_tree(draws(key)),
           "trainer": {"act_dtype": act_dtype, "fused_decoder": fused}, "gen": gen}
    return leg, (warm, jax.device_get(new), {k: float(v) for k, v in metrics.items()})


def update_distances(jax_side, got):
    """Per parameter tensor: the port's update's largest distance from the
    JAX step's, over that update's largest entry."""
    warm, new, _ = jax_side
    out = {}
    for tag, start, ref in (("params_g", warm.params_g, new.params_g),
                            ("params_d", warm.params_d, new.params_d)):
        start, ref = flatten_tree(np_tree(start)), flatten_tree(np_tree(ref))
        for k in ref:
            update = ref[k] - start[k]
            out[f"{tag}/{k}"] = (np.abs((got[tag][k] - start[k]) - update).max()
                                 / max(np.abs(update).max(), 1e-30))
    return out


def assert_replicated(ranks, name):
    """Every rank holds the same parameters after leg ``name``'s step."""
    r0, r1 = ranks[0][name], ranks[1][name]
    for tag in ("params_g", "params_d"):
        for k in r0[tag]:
            assert np.array_equal(r0[tag][k], r1[tag][k]), k


def assert_bf16_step(jax_side, got, lr):
    """A bf16-storage step held as ``tests/test_torch_act_dtype.py`` holds
    the single-device one: every parameter within lr / 10 and each tensor's
    update within 0.02 of the reference update's norm."""
    warm, new, _ = jax_side
    for tag in ("params_g", "params_d"):
        start = flatten_tree(np_tree(getattr(warm, tag)))
        ref = flatten_tree(np_tree(getattr(new, tag)))
        for k in ref:
            np.testing.assert_allclose(got[tag][k], ref[k], rtol=0, atol=lr / 10, err_msg=k)
            off = float(np.linalg.norm((got[tag][k] - start[k]) - (ref[k] - start[k])))
            assert off <= 0.02 * float(np.linalg.norm(ref[k] - start[k])) + 1e-12, (k, off)


def single_process_maxima(leg):
    """``(name, maximum)`` of every quantization point of the quantized full
    generator's forward on ``leg``'s global batch in one process (weights
    first where a layer has them)."""
    g = FullUNetGenerator(frame_length=leg["frame_length"], weight_bits=8, act_bits=16, **FULL)
    g.load_state_dict(from_jax_params(leg["pg"]))
    seen = []

    def record(m, name):
        seen.append((name, m.reshape(-1).numpy().copy()))
        return m

    with torch.no_grad():
        g(torch.from_numpy(np.array(leg["draws"][0]["noisy"])), amax=record)
    return seen


def scale_distance(got, want, rank=0, n=1):
    """The largest relative distance of a rank's quantization-point maxima
    from ``want``'s (a column-parallel kernel's are this rank's ``rank`` of
    ``n`` shards of the output channels); infinite where the points differ."""
    if [a for a, _ in got] != [b for b, _ in want]:
        return np.inf
    return max(float(np.abs(x / (y if len(x) == len(y) else np.split(y, n)[rank]) - 1).max())
               for (_, x), (_, y) in zip(got, want))
