"""The port's simpleGAN against the JAX package's: training steps on JAX's
own draws, the weight text files, the integer datapath and its LUTs.

JAX's ``train`` draws each step from ``split(key, n)`` and, per step,
``split(k, 3)`` -> ``randint``, ``normal``, ``normal``; ``jax_train_draws``
rebuilds those draws and hands them to ``train_from_draws``. After 300
steps, in both gradient modes, every parameter and every step's two
losses agree within 1e-5 (float32 rounding of 2- to 9-term dot products,
tanh, sigmoid and log; measured up to 7.5e-9 on the parameters and 2.4e-7
on the losses). The weight files are byte for byte (both write each
float32 weight from its float64 value), and the integer datapath, its
quantization and its LUTs equal JAX's exactly (both round half to even
and shift arithmetically).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdmgan_tpu import simplegan as jsg
from ofdmgan_tpu_torch import simplegan as sg
from ofdmgan_tpu_torch.simplegan import export as tex
from ofdmgan_tpu_torch.utils.jax_params import simplegan_from_numpy, simplegan_to_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KEY = jax.random.PRNGKey(0)
STEPS = 300


def jax_train_draws(key, n_steps):
    """The draws of ``jsg.train(key, ...)`` from its key splits
    (``ofdmgan_tpu/simplegan/model.py:171-180``)."""
    def one(k):
        k_idx, k_ng1, k_ng2 = jax.random.split(k, 3)
        return (jax.random.randint(k_idx, (), 0, 2), jax.random.normal(k_ng1, (2,)),
                jax.random.normal(k_ng2, (2,)))

    idx, ng1, ng2 = jax.vmap(one)(jax.random.split(key, n_steps))
    return {"idx": torch.from_numpy(np.array(idx)).long(), "ng1": torch.from_numpy(np.array(ng1)),
            "ng2": torch.from_numpy(np.array(ng2))}


@pytest.fixture(scope="module")
def trained():
    """(JAX params, port params) after STEPS steps on JAX's draws, per mode."""
    p0 = jsg.init_params(KEY)
    draws = jax_train_draws(jax.random.PRNGKey(1), STEPS)
    out = {}
    for mode in ("matlab", "exact"):
        pj, lj = jsg.train(jax.random.PRNGKey(1), p0, n_steps=STEPS, grad_mode=mode)
        pt, lt = sg.train_from_draws(simplegan_from_numpy(p0), **draws, grad_mode=mode)
        out[mode] = (pj, lj, pt, lt)
    return out


@pytest.mark.parametrize("mode", ["matlab", "exact"])
def test_training_steps_match_jax(trained, mode):
    pj, lj, pt, lt = trained[mode]
    for field, a, b in zip(pj._fields, pj, pt):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, field
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5, err_msg=field)
    for k in ("loss_d", "loss_g"):
        assert lt[k].shape == (STEPS,)
        np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]), rtol=0, atol=1e-5)
    # the generator moved only on the 1-based even steps: 150 updates
    assert not np.allclose(pt.wg2.numpy(), np.asarray(jsg.init_params(KEY).wg2))


def test_generator_schedule_is_one_based():
    """With dgl = 2 one step leaves G untouched and two steps move it."""
    p0 = sg.init_params(torch.Generator().manual_seed(0))
    draws = sg.make_train_draws(torch.Generator().manual_seed(1), 2)
    one, _ = sg.train_from_draws(p0, **{k: v[:1] for k, v in draws.items()})
    two, _ = sg.train_from_draws(p0, **draws)
    assert torch.equal(one.wg2, p0.wg2) and not torch.equal(one.wd2, p0.wd2)
    assert not torch.equal(two.wg2, p0.wg2)
    # train draws its steps from the generator it is given
    drawn, _ = sg.train(torch.Generator().manual_seed(1), p0, n_steps=2)
    assert all(torch.equal(a, b) for a, b in zip(drawn, two))


def test_forward_and_patterns_match_jax():
    p = jsg.init_params(KEY)
    tp = simplegan_from_numpy(p)
    np.testing.assert_array_equal(sg.patterns().numpy(), np.asarray(jsg.patterns()))
    for z in ([0.0, 0.0], [-1.0, 1.0], [-3.0, 3.0]):
        hj, ij = jsg.generator_forward(p, jnp.asarray(z))
        ht, it = sg.generator_forward(tp, torch.tensor(z))
        np.testing.assert_allclose(it.numpy(), np.asarray(ij), atol=1e-6)
        _, yj = jsg.discriminator_forward(p, ij)
        _, yt = sg.discriminator_forward(tp, it)
        assert float(yt) == pytest.approx(float(yj), abs=1e-6)
    ngs = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (9, 2)))
    np.testing.assert_allclose(sg.generate_samples(tp, ngs=torch.tensor(ngs)).numpy(),
                               np.asarray(jax.vmap(lambda z: jsg.generator_forward(p, z)[1])(
                                   ngs)).reshape(9, 3, 3), atol=1e-6)
    assert sg.pattern_score(tp).keys() == jsg.pattern_score(p).keys()


def test_init_shapes():
    p = sg.init_params(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in p] == [tuple(a.shape) for a in jsg.init_params(KEY)]
    assert all(not t.any() for t in (p.bg2, p.bg3, p.bd2, p.bd3))


@pytest.mark.parametrize("mode", ["init", "matlab", "exact"])
def test_weight_files_are_byte_identical(tmp_path, trained, mode):
    pj = jsg.init_params(KEY) if mode == "init" else trained[mode][0]
    pt = simplegan_from_numpy(pj) if mode == "init" else trained[mode][2]
    counts_j = jsg.export_weights_txt(pj, str(tmp_path / "jax"))
    counts_t = sg.export_weights_txt(pt, str(tmp_path / "port"))
    assert counts_t == counts_j
    for name in counts_j:
        a, b = (tmp_path / "jax" / name).read_text(), (tmp_path / "port" / name).read_text()
        if mode == "init":
            assert a == b, name
        else:   # trained on both sides: the integers equal, the floats to 1e-5
            for la, lb in zip(a.splitlines(), b.splitlines(), strict=True):
                qa, va = la.split(" // ")
                qb, vb = lb.split(" // ")
                assert qa == qb and float(vb) == pytest.approx(float(va), abs=1e-5)
    # trained port weights written by both packages: byte for byte
    jsg.export_weights_txt(jsg.SimpleGANParams(**simplegan_to_numpy(pt)), str(tmp_path / "j2"))
    for name in counts_j:
        assert (tmp_path / "j2" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()


def test_load_weights_round_trip(tmp_path, trained):
    pt = trained["matlab"][2]
    sg.export_weights_txt(pt, str(tmp_path))
    loaded = sg.load_weights_txt(str(tmp_path))
    loaded_j = jsg.load_weights_txt(str(tmp_path))
    for field, a, b, orig in zip(pt._fields, loaded_j, loaded, pt):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=field)
        step = 1 / 128 if field.startswith("w") else 1 / 256
        np.testing.assert_allclose(b.numpy(), orig.numpy(), rtol=0, atol=step / 2 + 1e-7)
    # re-exported, the quantized weights write the same integers
    sg.export_weights_txt(loaded, str(tmp_path / "again"))
    for name, _, _ in tex._FILES:
        ints = [ln.split(" // ")[0] for ln in (tmp_path / name).read_text().splitlines()]
        again = [ln.split(" // ")[0] for ln in (tmp_path / "again" / name).read_text().splitlines()]
        assert ints == again


def test_luts_match_jax():
    x = np.arange(-40000, 40000, 3)
    np.testing.assert_array_equal(tex.tanh_lut_q88(torch.from_numpy(x)).numpy(),
                                  jsg.export.tanh_lut_q88(x))
    np.testing.assert_array_equal(tex.sigmoid_lut_q88(torch.from_numpy(x)).numpy(),
                                  jsg.export.sigmoid_lut_q88(x))


@pytest.mark.parametrize("mode", ["init", "matlab"])
def test_integer_datapath_matches_jax(trained, mode):
    pj = jsg.init_params(KEY) if mode == "init" else trained[mode][0]
    qj = jsg.quantize_params(pj)
    qt = sg.quantize_params(simplegan_from_numpy(pj))
    for k in qj:
        assert qt[k].dtype == torch.int64
        np.testing.assert_array_equal(qt[k].numpy(), qj[k], err_msg=k)
    ngs = np.arange(-2048, 2048, 4).reshape(-1, 2)   # Q8.8 latents over [-8, 8)
    imgs_t = sg.generator_int_forward(qt, torch.from_numpy(ngs))
    scores_t = sg.discriminator_int_forward(qt, imgs_t)
    for ng, img_t, s_t in zip(ngs, imgs_t, scores_t):
        img_j = jsg.generator_int_forward(qj, ng)
        np.testing.assert_array_equal(img_t.numpy(), img_j)
        assert int(s_t) == jsg.discriminator_int_forward(qj, img_j)
    assert int(sg.discriminator_int_forward(qt, imgs_t[0])) == int(scores_t[0])


def test_bridge_round_trip():
    p = jsg.init_params(KEY)
    tp = simplegan_from_numpy(p)
    back = jsg.SimpleGANParams(**simplegan_to_numpy(tp))
    for a, b in zip(p, back):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert all(torch.equal(a, b) for a, b in zip(simplegan_from_numpy(back), tp))
