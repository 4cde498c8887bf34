"""The port's Q-formats, fake quantization and bit-true integer datapath
against the JAX package, on numpy inputs made from seeds.

Q-format, fake-quantization and integer results are held bit for bit
(``assert_array_equal``): the arithmetic is the same elementwise float32 or
int32 in both. The integer datapath is also held bit
for bit against the native C++ engine ``native/fixsim.cpp``, through the
port's binding and the JAX package's, against the committed RTL-residual
handoff vectors of the committed ``rtl_qat`` champion, and against the
committed golden input encoding.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu.models import MiniDiscriminator as JCritic
from ofdmgan_tpu.models import MiniGenerator as JGen
from ofdmgan_tpu.quant import fakequant as jfq
from ofdmgan_tpu.quant import intsim as ji
from ofdmgan_tpu.quant import qformat as jqf
from ofdmgan_tpu.verify import cosim as j_cosim
from ofdmgan_tpu.verify.golden import read_hex
from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.quant import fakequant as tfq
from ofdmgan_tpu_torch.quant import intsim as ti
from ofdmgan_tpu_torch.quant import qformat as tqf
from ofdmgan_tpu_torch.quant.rom_codegen import pack_rom_arrays
from ofdmgan_tpu_torch.utils.jax_params import from_jax_params
from ofdmgan_tpu_torch.utils.params_io import load_params_tree
from ofdmgan_tpu_torch.verify import cosim as t_cosim
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "docs" / "verification_output" / "golden_vectors"
HANDOFF = REPO / "rtl" / "handoff_rtl_residual" / "vectors"
RTL_CHAMPION = REPO / "results" / "residual_checkpoints" / "rtl_qat" / "champion_params_g.npz"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got: torch.Tensor, ref):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))


# ------------------------------------------------------------- qformat


@pytest.mark.parametrize("n_bits", [4, 8, 16])
@pytest.mark.parametrize("per_channel,axis", [(False, 0), (True, 0), (True, 2), (True, -1)])
def test_scale_quantize_dequantize(n_bits, per_channel, axis):
    x = np.random.default_rng(n_bits).standard_normal((8, 4, 3)).astype(np.float32) * 2
    x[1] = 0.0   # an all-zero channel takes the 1e-8 floor
    s_ref = jqf.compute_scale(jnp.asarray(x), n_bits, per_channel, axis)
    s = tqf.compute_scale(_t(x), n_bits, per_channel, axis)
    _eq(s, s_ref)
    q_ref = jqf.quantize(jnp.asarray(x), s_ref, n_bits)
    q = tqf.quantize(_t(x), s, n_bits)
    _eq(q, q_ref)
    _eq(tqf.dequantize(q, s), jqf.dequantize(q_ref, s_ref))


@pytest.mark.parametrize("rounding", ["round", "trunc"])
@pytest.mark.parametrize("frac,width", [(7, 8), (8, 16), (16, 32)])
def test_float_to_fixed_and_back(rounding, frac, width):
    rng = np.random.default_rng(frac)
    x = (rng.standard_normal(4096) * 4).astype(np.float32)
    x[:6] = [0.5 / 2 ** frac, 1.5 / 2 ** frac, -0.5 / 2 ** frac, 1e9, -1e9, 0.0]  # halves, saturation
    q = tqf.float_to_fixed(_t(x), frac, width, rounding)
    assert q.dtype == torch.int32
    _eq(q, jqf.float_to_fixed(jnp.asarray(x), frac, width, rounding))
    _eq(tqf.fixed_to_float(q, frac), jqf.fixed_to_float(jnp.asarray(q.numpy()), frac))
    with pytest.raises(ValueError):
        tqf.float_to_fixed(_t(x), frac, width, "floor")


def test_hex_and_constants():
    for v in (0, 1, -1, 322, -74, 32767, -32768, 127, -128, 70000):
        assert tqf.to_hex16(v) == jqf.to_hex16(v)
        assert tqf.to_hex8(v) == jqf.to_hex8(v)
    assert (tqf.Q17_FRAC, tqf.Q88_FRAC, tqf.Q1616_FRAC) == (jqf.Q17_FRAC, jqf.Q88_FRAC,
                                                            jqf.Q1616_FRAC)


# ------------------------------------------------------------- fakequant


@pytest.mark.parametrize("n_bits", [4, 8, 16])
def test_fake_quantize_forward_and_identity_gradient(n_bits):
    x = np.random.default_rng(n_bits).standard_normal((64, 5)).astype(np.float32)
    ref = jfq.fake_quantize_auto(jnp.asarray(x), n_bits, per_channel=True, channel_axis=1)
    xt = _t(x).requires_grad_(True)
    got = tfq.fake_quantize_auto(xt, n_bits, per_channel=True, channel_axis=1)
    _eq(got, ref)
    _eq(tfq.fake_quantize(_t(x), 0.01, n_bits), jfq.fake_quantize(jnp.asarray(x), 0.01, n_bits))
    (got * 3.0).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), 3.0)
    jgrad = jax.grad(lambda v: jnp.sum(3.0 * jfq.fake_quantize_auto(v, n_bits, True, 1)))(x)
    _eq(xt.grad, jgrad)


# ------------------------------------------------------------- intsim


def _random_int_params(seed, bias_scale=2048):
    """Integer weights over the whole Q1.7 range and Q8.8 biases; each
    layer as (weight, bias) numpy arrays."""
    rng = np.random.default_rng(seed)
    shapes = {"gen": [(4, 2, 3), (8, 4, 3), (4, 8, 3), (2, 4, 3)],
              "disc": [(8, 4, 3), (16, 8, 3), (1, 16)]}
    return {k: [(rng.integers(-128, 128, s).astype(np.int32),
                 rng.integers(-bias_scale, bias_scale, s[0]).astype(np.int32)) for s in v]
            for k, v in shapes.items()}


def _frames(seed, n=256, scale=1.5):
    """Q8.8 frames ``[n, 16, 2]``: gaussian, and saturating rows."""
    x = np.random.default_rng(seed).standard_normal((n, 16, 2)).astype(np.float32) * scale
    x[:4] = np.array([32767 / 256, -128.0, 0.0, 1.0])[:, None, None]
    return np.array(ji.float_to_q88(jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["rtl", "rtl_residual", "float_ref"])
def test_generator_int_forward_is_bit_exact(seed, mode):
    p = _random_int_params(seed)["gen"]
    jp = ji.IntGenParams(*(ji.IntLayer(w, b) for w, b in p))
    tp = ti.IntGenParams(*(ti.IntLayer(w, b) for w, b in p))
    x = _frames(10 + seed)
    got = ti.generator_int_forward(tp, torch.from_numpy(x), mode)
    assert got.dtype == torch.int32 and got.shape == x.shape
    _eq(got, ji.generator_int_forward(jp, jnp.asarray(x), mode))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("mode", ["rtl", "float_ref"])
def test_discriminator_int_forward_is_bit_exact(seed, mode):
    """Large biases drive the pooled sums past 16 bits, where the RTL reads
    their low half."""
    p = _random_int_params(seed, bias_scale=16384)["disc"]
    jp = ji.IntDiscParams(*(ji.IntLayer(w, b) for w, b in p))
    tp = ti.IntDiscParams(*(ti.IntLayer(w, b) for w, b in p))
    cand, cond = _frames(20 + seed), _frames(30 + seed, scale=3.0)
    got = ti.discriminator_int_forward(tp, torch.from_numpy(cand), torch.from_numpy(cond), mode)
    assert got.shape == (len(cand), 1)
    _eq(got, ji.discriminator_int_forward(jp, jnp.asarray(cand), jnp.asarray(cond), mode))


def test_chunks_and_float_weights_give_the_same_result(monkeypatch):
    """Trained float weights reach the datapath through
    ``quantize_weights_rtl`` from a model of the port or its flax tree; a
    batch split into chunks gives the result of one pass."""
    pg = _np(JGen().init(jax.random.PRNGKey(4), jnp.zeros((1, 16, 2))))
    pg = jax.tree_util.tree_map(lambda a: a * 2.5 + 0.03, pg)   # non-zero biases
    tg = MiniGenerator()
    tg.load_state_dict(from_jax_params(pg))
    ref = ji.quantize_weights_rtl(pg, "generator")
    for src in (pg, tg):
        for got, want in zip(ti.quantize_weights_rtl(src, "generator"), ref):
            np.testing.assert_array_equal(got.weight, want.weight)
            np.testing.assert_array_equal(got.bias, want.bias)
    ip = ti.quantize_weights_rtl(tg, "generator")
    x = torch.from_numpy(_frames(7, n=300))
    whole = ti.generator_int_forward(ip, x, "rtl_residual")
    monkeypatch.setattr(ti, "CHUNK", 64)
    assert torch.equal(ti.generator_int_forward(ip, x, "rtl_residual"), whole)
    _eq(whole, ji.generator_int_forward(ref, jnp.asarray(x.numpy()), "rtl_residual"))
    with pytest.raises(ValueError):
        ti.generator_int_forward(ip, x, "rtl_fast")


def test_float_to_q88_and_tanh_on_every_q88_value():
    """Truncation toward zero with saturation; the float_ref mode's tanh is
    XLA's float32 tanh bit for bit on all 65,536 Q8.8 values."""
    grid = np.arange(-32768, 32768, dtype=np.int32).astype(np.float32) / 256.0
    np.testing.assert_array_equal(ti._tanh_f32(_t(grid)).numpy(), np.asarray(jnp.tanh(grid)))
    x = np.concatenate([grid + 1.0 / 512, grid - 1.0 / 1024, [1e6, -1e6]]).astype(np.float32)
    _eq(ti.float_to_q88(_t(x)), ji.float_to_q88(jnp.asarray(x)))
    q = _t(np.arange(-32768, 32768, dtype=np.int32))
    _eq(ti.q88_to_float(q), ji.q88_to_float(jnp.asarray(q.numpy())))


# ------------------------------------------------------------- fixsim


@pytest.mark.parametrize("residual", [False, True])
def test_generator_matches_fixsim_through_both_bindings(residual):
    pg = _np(JGen().init(jax.random.PRNGKey(6), jnp.zeros((1, 16, 2))))
    pg = jax.tree_util.tree_map(lambda a: a * 3.0 + 0.05, pg)
    tg = MiniGenerator()
    tg.load_state_dict(from_jax_params(pg))
    rom_w, rom_b = pack_rom_arrays(tg)
    x = _frames(40, n=512)
    mode = "rtl_residual" if residual else "rtl"
    got = ti.generator_int_forward(ti.quantize_weights_rtl(tg), torch.from_numpy(x), mode)
    x_ncl = np.ascontiguousarray(np.swapaxes(x, 1, 2).astype(np.int16))
    want = np.swapaxes(got.numpy(), 1, 2).astype(np.int16)
    np.testing.assert_array_equal(t_cosim.generator_forward(rom_w, rom_b, x_ncl, residual), want)
    if j_cosim.available():   # the JAX package's binding of the same engine
        np.testing.assert_array_equal(
            j_cosim.generator_forward(rom_w, rom_b, x_ncl, residual=residual), want)


def test_critic_matches_fixsim_through_both_bindings():
    pd = _np(JCritic().init(jax.random.PRNGKey(9), jnp.zeros((1, 16, 2)), jnp.zeros((1, 16, 2))))
    pd = jax.tree_util.tree_map(lambda a: a * 2.0 + 0.05, pd)
    tc = MiniDiscriminator()
    tc.load_state_dict(from_jax_params(pd))
    rom_w, rom_b = pack_rom_arrays(None, tc)
    cand, cond = _frames(41, n=512), _frames(42, n=512, scale=3.0)
    got = ti.discriminator_int_forward(ti.quantize_weights_rtl(tc, "discriminator"),
                                       torch.from_numpy(cand), torch.from_numpy(cond))
    ncl = [np.ascontiguousarray(np.swapaxes(a, 1, 2).astype(np.int16)) for a in (cand, cond)]
    want = got.numpy()[:, 0].astype(np.int16)
    np.testing.assert_array_equal(t_cosim.discriminator_forward(rom_w, rom_b, *ncl), want)
    if j_cosim.available():
        np.testing.assert_array_equal(j_cosim.discriminator_forward(rom_w, rom_b, *ncl), want)


def test_fixsim_binding_checks_its_inputs():
    rom_w, rom_b = np.zeros(2048, np.int8), np.zeros(64, np.int16)
    with pytest.raises(ValueError):
        t_cosim.generator_forward(rom_w, rom_b, np.zeros((2, 16, 2), np.int16))
    with pytest.raises(ValueError):
        t_cosim.generator_forward(rom_w[:100], rom_b, np.zeros((2, 2, 16), np.int16))
    with pytest.raises(ValueError):
        t_cosim.discriminator_forward(rom_w, rom_b, np.zeros((2, 2, 16), np.int16),
                                      np.zeros((3, 2, 16), np.int16))
    assert t_cosim.library_path().parent == REPO / "build" / "fixsim"


# ------------------------------------------------------------- committed artifacts


def test_rtl_qat_champion_reproduces_the_handoff_vectors():
    """The committed RTL-QAT champion's integer forward (``rtl_residual``)
    gives every committed expected output of the RTL handoff bundle."""
    from scripts.make_rtl_handoff import make_test_frames

    ip = ti.quantize_weights_rtl(load_params_tree(str(RTL_CHAMPION)), "generator")
    frames = make_test_frames()
    assert len(frames) == len(list(HANDOFF.glob("*_out.hex")))
    for name, frame in frames.items():
        xq = ti.float_to_q88(_t(frame[None].astype(np.float32)))
        yq = ti.generator_int_forward(ip, xq, "rtl_residual")
        np.testing.assert_array_equal(read_hex(HANDOFF / f"{name}_in.hex"),
                                      xq[0].T.flatten().numpy().astype(np.int16))
        np.testing.assert_array_equal(read_hex(HANDOFF / f"{name}_out.hex"),
                                      yq[0].T.flatten().numpy().astype(np.int16), err_msg=name)


def test_golden_input_encoding():
    x = np.load(GOLDEN / "input_float.npy")
    np.testing.assert_array_equal(ti.float_to_q88(_t(x)).numpy(), np.load(GOLDEN / "input_q88.npy"))
