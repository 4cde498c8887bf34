"""The port's full U-Net family against the JAX package's.

Weights are made by the flax models from a seed and carried to torch by
``from_jax_params``; inputs are numpy draws from a seed. Tolerance: atol
1e-5 (rtol 1e-5) on forwards, the float32 rounding of up to 23 chained
k = 3 convolutions with tanh-bounded outputs and critic scores of order
one to ten; the weight bridge is exact.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models.full_unet import FullDiscriminator as JCritic
from ofdmgan_tpu.models.full_unet import FullUNetGenerator as JGen
from ofdmgan_tpu.models.full_unet import full_unet_layer_names as j_layer_names
from ofdmgan_tpu.utils.params_io import load_params_tree as j_load
from ofdmgan_tpu_torch.models import count_parameters
from ofdmgan_tpu_torch.models.full_unet import (FullDiscriminator, FullUNetGenerator,
                                                full_unet_layer_names)
from ofdmgan_tpu_torch.training.trainer import Trainer
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params, to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree, load_params_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CHAMPION = (Path(__file__).resolve().parents[1]
            / "results/full_fading_gan_v4/champion_params_g.npz")
KEY = jax.random.PRNGKey(0)
SMALL = [(2, 4, 32), (3, 8, 64)]   # (levels, base_channels, frame length)


def _frames(seed, b, L):
    return np.random.default_rng(seed).standard_normal((b, L, 2)).astype(np.float32) * 0.5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _pair(levels, base, L, seed=1):
    """(JAX generator, its params, port generator, JAX critic, its params,
    port critic) on the same weights; shared by the tests, which leave them
    unchanged."""
    x0 = jnp.zeros((1, L, 2))
    jg, jc = JGen(frame_length=L, levels=levels, base_channels=base), \
        JCritic(frame_length=L, levels=levels, base_channels=base)
    pg = jax.jit(jg.init)(jax.random.PRNGKey(seed), x0)
    pd = jax.jit(jc.init)(jax.random.PRNGKey(seed + 1), x0, x0)
    tg = FullUNetGenerator(frame_length=L, levels=levels, base_channels=base)
    tc = FullDiscriminator(frame_length=L, levels=levels, base_channels=base)
    tg.load_state_dict(from_jax_params(_np(pg)))
    tc.load_state_dict(from_jax_params(_np(pd)))
    return jg, pg, tg, jc, pd, tc


@pytest.mark.parametrize("levels,base,L", SMALL)
def test_generator_forward(levels, base, L):
    jg, pg, tg, *_ = _pair(levels, base, L)
    x = _frames(2, 8, L)
    with torch.no_grad():
        got = tg(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jg.apply)(pg, x)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("levels,base,L", SMALL)
def test_critic_forward(levels, base, L):
    *_, jc, pd, tc = _pair(levels, base, L)
    a, b = _frames(3, 8, L), _frames(4, 8, L)
    with torch.no_grad():
        got = tc(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jc.apply)(pd, a, b)), rtol=1e-5, atol=1e-5)


def test_encode_then_decode_is_the_forward():
    _, _, tg, *_ = _pair(3, 8, 64)
    x = torch.from_numpy(_frames(5, 4, 64))
    with torch.no_grad():
        h, skips = tg.encode(x)
        assert [s.shape[-1] for s in skips] == [32, 16, 8] and h.shape == (4, 32, 8)
        assert torch.equal(tg.decode(h, skips), tg(x))


def test_full_width_layers_and_shapes_match_jax():
    """Layer names and every parameter's shape at levels 5, base 32, against
    the JAX tree (by shape only; no forward at this width)."""
    assert full_unet_layer_names(5) == j_layer_names(5)
    x0 = jax.ShapeDtypeStruct((1, 1024, 2), jnp.float32)
    for jmod, tmod in ((JGen(), FullUNetGenerator()), (JCritic(), FullDiscriminator())):
        args = (x0,) if isinstance(jmod, JGen) else (x0, x0)
        shapes = jax.eval_shape(lambda *a: jmod.init(KEY, *a), *args)
        ref = flatten_tree(jax.tree_util.tree_map(lambda s: np.empty(s.shape, s.dtype), shapes))
        got = flatten_tree(to_jax_params(tmod))
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].shape == tuple(ref[k].shape), k
    layers = {k.split(".")[0] for k in FullUNetGenerator().state_dict()}
    assert layers == set(j_layer_names(5))


def test_parameter_counts():
    x0 = jax.ShapeDtypeStruct((1, 1024, 2), jnp.float32)
    count = lambda tree: sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))  # noqa: E731
    assert count_parameters(FullUNetGenerator()) == 3_936_578 == \
        count(jax.eval_shape(lambda x: JGen().init(KEY, x), x0))
    assert count_parameters(FullDiscriminator()) == 524_129 == \
        count(jax.eval_shape(lambda x: JCritic().init(KEY, x, x), x0))


def test_committed_full_champion_matches_the_jax_forward():
    """The committed 46-leaf full champion loads through ``params_io`` and
    the bridge; its L = 1024 forward on two frames matches JAX's."""
    tree = load_params_tree(str(CHAMPION))
    assert len(flatten_tree(tree)) == 46
    tg = FullUNetGenerator()
    tg.load_state_dict(from_jax_params(tree))
    x = _frames(6, 2, 1024)
    with torch.no_grad():
        got = tg(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(JGen().apply)(j_load(str(CHAMPION)), x))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["generator", "critic"])
def test_bridge_round_trip_is_exact(which):
    jg, pg, tg, jc, pd, tc = _pair(3, 8, 64, seed=7)
    tree, module = (pg, tg) if which == "generator" else (pd, tc)
    ref = flatten_tree(_np(tree))
    back = flatten_tree(to_jax_params(module))   # loaded through from_jax_params
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def test_a_two_level_critic_keeps_its_own_keys():
    """A two-level, base-8 full critic has the mini critic's torch keys and
    shapes; given the module, the bridge writes the full family's keys."""
    tc = FullDiscriminator(frame_length=32, levels=2, base_channels=8)
    assert set(flatten_tree(to_jax_params(tc))) == {
        "params/conv1/kernel", "params/conv1/bias", "params/conv2/kernel",
        "params/conv2/bias", "params/dense/kernel", "params/dense/bias"}


@pytest.mark.parametrize("kw", [dict(weight_bits=8), dict(act_bits=16)])
def test_quantized_modes_raise(kw):
    """The quantized forward takes no fused decoder (reference
    trainer.py:265-268) and, on a step that casts its batch, no activation
    storage format (the reference's ``_QuantConv`` refuses a bf16 input)."""
    g = FullUNetGenerator(frame_length=64, levels=3, base_channels=4, **kw)
    d = FullDiscriminator(frame_length=64, levels=3, base_channels=4)
    with pytest.raises(ValueError, match="fused_decoder"):
        Trainer(device="cpu", generator=g, discriminator=d, fused_decoder=True)
    with pytest.raises(ValueError, match="the reference cannot run it either"):
        Trainer(device="cpu", generator=g, discriminator=d, act_dtype="bfloat16")


def test_frame_length_must_divide_by_two_to_the_levels():
    with pytest.raises(ValueError):
        FullUNetGenerator(frame_length=48, levels=5)
    tg = FullUNetGenerator(frame_length=64, levels=3, base_channels=4)
    with pytest.raises(ValueError):
        tg(torch.zeros(1, 36, 2))
    with pytest.raises(ValueError):
        FullDiscriminator(frame_length=64, levels=3, base_channels=4)(
            torch.zeros(1, 36, 2), torch.zeros(1, 36, 2))
