"""The port's global (GSPMD) step against the JAX package's, per layout.

The JAX side runs ``make_gspmd_train_step`` on the conftest's virtual CPU
devices: the mini pair on ``{dp: 2}`` (as ``tests/test_gspmd.py:204-234``)
and the full U-Net (L = 64, 3 levels, base 8, n_critic 1) on ``{tp: 2}``
and ``{sp: 2}`` with ``unet_param_shardings``. Three JAX steps warm each
state up; the port's two gloo ranks (``tests/torch_parallel_ranks.py``,
spawned once for the module) load that state (parameters and Adam
moments) and take one more step on the JAX step's global draws, rebuilt
from its key splits (``wgan_gp.py:315, 333``), each rank on its shard.
Tolerance: each parameter tensor's update within 3e-4 of that update's
largest entry, from the warmed-up state (from a fresh Adam state a gradient
that is zero up to rounding becomes a full step of either sign). Measured
on the CPU: 9.3e-5 (mini, ``bottleneck`` conv kernel), 8.4e-5 (tp) and
4.2e-5 (sp): XLA's and ATen's float32 convolutions round apart, and Adam
with b1 = 0 divides each gradient entry by its own running scale, which
turns an entry's rounding into that share of an update; 1e-5 is below that
floor. The gate's power: the tp and sp legs again, each with one collective
left out (Megatron's ``f``, the halo exchange, the sum of the partial
gradients over ``sp``), lie more than a tenth of a largest update away.

The penalty's double backward under ``sp`` (halo exchanges and sums over
``sp`` inside the critic's input gradient, differentiated again) is held
on its own: the critic's parameter gradients summed over ``sp`` against the
single-process gradients of the same loss, within 1e-5 of each tensor's
largest entry (float32 sums in another order); and the halo exchange's
backward is its transpose to float64 rounding.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.models.full_unet import FullDiscriminator as JFullCritic
from ofdmgan_tpu.models.full_unet import FullUNetGenerator as JFullGen
from ofdmgan_tpu.models.full_unet import unet_param_shardings as j_unet_param_shardings
from ofdmgan_tpu.parallel import make_mesh as j_make_mesh
from ofdmgan_tpu.parallel.gspmd import make_gspmd_train_step as j_gspmd_step
from ofdmgan_tpu.signal import DatagenConfig as JDatagenConfig
from ofdmgan_tpu.signal import synthetic_batch as j_synthetic_batch
from ofdmgan_tpu.training import make_adam as j_make_adam
from ofdmgan_tpu.training.wgan_gp import LossConfig as JLossConfig
from ofdmgan_tpu_torch.models.full_unet import (FullDiscriminator, FullUNetGenerator,
                                                unet_param_shardings,
                                                unet_param_shardings_rowparallel)
from ofdmgan_tpu_torch.parallel import distributed
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, critic_loss_fn
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from torch_parallel_ranks import MUTATIONS, gspmd_legs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KEY = jax.random.PRNGKey(0)
LR, WARM_STEPS, REL = 2e-4, 3, 3e-4
MUTATION_REL = 0.1   # a step without one of its collectives lies at least this far away
LAUNCH_TIMEOUT_S = 120
LEGS = {  # name: (JAX mesh, family, frame length, global batch, n_critic)
    "mini_dp": ({"dp": 2}, "mini", 16, 64, 2),
    "full_tp": ({"dp": 1, "tp": 2}, "full", 64, 8, 1),
    "full_sp": ({"dp": 1, "sp": 2}, "full", 64, 8, 1),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_leg(mesh_axes, family, L, batch, n_critic):
    """Warm a JAX GSPMD state up, take one more step; returns the port's
    inputs (the warmed state and that step's global draws) and JAX's
    warmed and stepped states."""
    mesh = j_make_mesh(mesh_axes, devices=jax.devices()[:2])
    x0 = jnp.zeros((1, L, 2))
    if family == "mini":
        jg, jc = JGen(), JCritic()
    else:
        jg = JFullGen(frame_length=L, levels=3, base_channels=8)
        jc = JFullCritic(frame_length=L, levels=3, base_channels=8)
    jdg = JDatagenConfig.make(frame_length=L)
    make_state, step = j_gspmd_step(
        jg.apply, jc.apply, j_make_adam(LR), j_make_adam(LR), jdg,
        JLossConfig(n_critic=n_critic), global_batch_size=batch, mesh=mesh,
        gen_tp_rule=j_unet_param_shardings if family == "full" else None, donate=False)
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
        return (_np(o[0].mu), _np(o[0].nu), int(o[0].count))

    leg = {"mesh": mesh_axes, "family": family, "frame_length": L, "batch": batch,
           "n_critic": n_critic, "lr": LR, "pg": _np(warm.params_g), "pd": _np(warm.params_d),
           "opt_g": opt(warm.opt_g), "opt_d": opt(warm.opt_d), "draws": _np(draws(key))}
    return leg, warm, jax.device_get(new), {k: float(v) for k, v in metrics.items()}


def _gp_leg():
    """A full critic, a batch, a fake and the penalty's uniforms for the
    double-backward check under sp."""
    rng = np.random.default_rng(7)
    jc = JFullCritic(frame_length=64, levels=3, base_channels=8)
    pd = _np(jc.init(KEY, jnp.zeros((1, 64, 2)), jnp.zeros((1, 64, 2))))
    f32 = np.float32
    batch = {"clean": rng.normal(size=(6, 64, 2)).astype(f32),
             "noisy": rng.normal(size=(6, 64, 2)).astype(f32)}
    return {"mesh": {"sp": 2}, "pd": pd, "batch": batch,
            "fake": rng.normal(size=(6, 64, 2)).astype(f32),
            "alpha": rng.uniform(size=6).astype(f32)}


@pytest.fixture(scope="module")
def runs():
    # the three JAX steps compile in threads (XLA compiles outside the GIL)
    with ThreadPoolExecutor(len(LEGS)) as pool:
        done = {name: pool.submit(_jax_leg, *args) for name, args in LEGS.items()}
        jax_side, legs = {}, {}
        for name, fut in done.items():
            legs[name], *jax_side[name] = fut.result()
    legs["gp"] = _gp_leg()
    ranks = distributed.launch(gspmd_legs, 2, (legs,), threads=1, timeout_s=LAUNCH_TIMEOUT_S)
    return legs, jax_side, ranks


def _update_distances(jax_side, name, got):
    """Per parameter tensor: the port's update's largest distance from the
    JAX step's, over that update's largest entry."""
    warm, new, _ = jax_side[name]
    out = {}
    for tag, start, ref in (("params_g", warm.params_g, new.params_g),
                            ("params_d", warm.params_d, new.params_d)):
        start, ref = flatten_tree(_np(start)), flatten_tree(_np(ref))
        for k in ref:
            update = ref[k] - start[k]
            out[f"{tag}/{k}"] = (np.abs((got[tag][k] - start[k]) - update).max()
                                 / max(np.abs(update).max(), 1e-30))
    return out


@pytest.mark.parametrize("name", list(LEGS))
def test_global_step_matches_jax(runs, name):
    legs, jax_side, ranks = runs
    _, _, jm = jax_side[name]
    r0, r1 = ranks[0][name], ranks[1][name]
    for tag in ("params_g", "params_d"):
        for k in r0[tag]:
            assert np.array_equal(r0[tag][k], r1[tag][k]), k   # replicated after the step
    for k, rel in _update_distances(jax_side, name, r0).items():
        assert rel <= REL, (k, rel)
    for k, v in jm.items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    if name == "full_tp":   # this rank trained shards of the sharded kernels
        g = FullUNetGenerator(frame_length=64, levels=3, base_channels=8)
        spec = unet_param_shardings(g, 2)
        for n, p in g.named_parameters():
            want = list(p.shape)
            if spec[n] is not None:
                want[spec[n]] //= 2
            assert r0["local_shapes"][n] == tuple(want), n
        assert any(d is not None for d in spec.values())
    if name == "mini_dp":
        assert r0["routes"] == ("kernel", "kernel")


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_a_missing_collective_fails_the_gate(runs, mutation):
    """The gate has power: a step without one of its collectives lies far
    outside REL of the JAX step's update."""
    _, jax_side, ranks = runs
    leg = MUTATIONS[mutation][0]
    worst = max(_update_distances(jax_side, leg, ranks[0][mutation]).values())
    assert worst >= MUTATION_REL, (mutation, worst)


def test_penalty_double_backward_through_the_sp_collectives(runs):
    legs, _, ranks = runs
    leg = legs["gp"]
    d = FullDiscriminator(frame_length=64, levels=3, base_channels=8)
    d.load_state_dict(from_jax_params(leg["pd"]))
    batch = {k: torch.from_numpy(v) for k, v in leg["batch"].items()}
    fake = torch.from_numpy(leg["fake"])
    loss, aux = critic_loss_fn(d, lambda x: fake, batch, torch.from_numpy(leg["alpha"]),
                               LossConfig())
    grads = torch.autograd.grad(loss, list(d.parameters()))
    assert float(aux["gradient_penalty"]) > 0
    for r in ranks:
        got = r["gp"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["gradient_penalty"],
                                   float(aux["gradient_penalty"]), rtol=1e-5)
        for (n, _), g in zip(d.named_parameters(), grads):
            ref = g.numpy()
            np.testing.assert_allclose(got["grads"][n], ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(), err_msg=n)


def test_the_halo_exchange_backward_is_its_transpose(runs):
    assert runs[2][0]["halo_adjoint"] < 1e-12


@pytest.mark.parametrize("rule", [unet_param_shardings, unet_param_shardings_rowparallel])
def test_sharding_rules_match_the_reference(rule):
    """Each rule shards the same parameters on the same axis as the JAX
    rule (flax kernels ``[k, C_in, C_out]`` against the port's ``[C_out,
    C_in, k]``)."""
    from ofdmgan_tpu.models import full_unet as jfu

    jrule = getattr(jfu, rule.__name__)
    jg = JFullGen(frame_length=64, levels=3, base_channels=8)
    pg = jg.init(KEY, jnp.zeros((1, 64, 2)))
    mesh = j_make_mesh({"dp": 1, "tp": 2}, devices=jax.devices()[:2])
    jspecs = {"/".join(p.key for p in path): s.spec for path, s in
              jax.tree_util.tree_flatten_with_path(jrule(pg, mesh))[0]}
    g = FullUNetGenerator(frame_length=64, levels=3, base_channels=8)
    spec = rule(g, 2)
    torch_axis = {0: 2, 1: 1}   # C_out, C_in in flax's kernel layout
    for name in spec:
        layer, leaf = name.rsplit(".", 1)
        jspec = tuple(jspecs[f"params/{layer}/{'kernel' if leaf == 'weight' else 'bias'}"])
        want = next((i for i, a in enumerate(jspec) if a == "tp"), None)
        got = spec[name]
        if leaf == "weight":
            got = None if got is None else torch_axis[got]
        assert got == want, (name, spec[name], jspec)
