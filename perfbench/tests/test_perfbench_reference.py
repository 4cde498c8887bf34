"""The plain reference against the port on the CPU, at tiny sizes: its
Philox against Random123's known answers, its batch against the port's
datagen on the same draws, and its outer step against the port's step on
the same weights and draws. The reference imports nothing of the port;
these tests do, to hold the two against each other."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.program import Program, make_weights
from perfbench.reference import datagen as ref_datagen
from perfbench.reference.philox import box_muller, philox4x32_10
from perfbench.reference.wgan_gp import Trainer

HERE = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def load(kind, name):
    return json.loads((HERE / kind / f"{name}.json").read_text())


# Random123's kat_vectors for philox4x32 with 10 rounds: (counter, key, output)
KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
        (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    assert tuple(int(x) for x in philox4x32_10(ctr, key)) == want


def test_philox_is_elementwise_over_counters():
    f = torch.arange(5, dtype=torch.int64)
    words = philox4x32_10((f, 0, 2, 7), (123, 456))
    for i in range(5):
        assert tuple(int(w[i]) for w in words) == tuple(
            int(x) for x in philox4x32_10((i, 0, 2, 7), (123, 456)))


def test_box_muller_matches_the_kernels_plain_version():
    from ofdmgan_tpu_torch.ops.datagen_kernel import box_muller_plain
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, size=(1000, 2), dtype=np.uint64)
    bits[0] = (0xFFFFFFFF, 0)   # the top uniform: radius near 0, finite
    want = box_muller_plain(torch.from_numpy(bits.astype(np.uint32).view(np.int32)))
    words = torch.from_numpy(bits.astype(np.int64))
    got = torch.stack(box_muller(words[:, 0], words[:, 1]), dim=1)
    np.testing.assert_allclose(got.numpy(), want.double().numpy(), rtol=1e-6, atol=1e-6)


def test_normals_from_seed_lay_out_every_stream():
    d = ref_datagen.normals_from_seed(2 ** 40 + 17, 3, 16, True)
    assert {k: v.shape for k, v in d.items()} == {
        "zr": (3, 16), "zi": (3, 16), "nr": (3, 16), "ni": (3, 16), "pn": (3, 16), "u": (3,)}
    # stream 0, frame 1, call 2: samples 4 and 5
    w = philox4x32_10((1, 0, 0, 2), (17, 2 ** 8))
    re0, im0 = box_muller(w[0], w[1])
    re1, im1 = box_muller(w[2], w[3])
    assert (d["zr"][1, 4], d["zi"][1, 4], d["zr"][1, 5], d["zi"][1, 5]) == (re0, im0, re1, im1)
    # stream 1, frame 2, call 1: pn[2], pn[3], pn[10], pn[11]
    w = philox4x32_10((2, 0, 1, 1), (17, 2 ** 8))
    a, c = box_muller(w[0], w[1]), box_muller(w[2], w[3])
    got = (d["pn"][2, 2], d["pn"][2, 3], d["pn"][2, 10], d["pn"][2, 11])
    assert got == (a[0], c[0], a[1], c[1])
    assert bool(torch.all((d["u"] > 0) & (d["u"] < 1)))


DATAGEN = [
    {"snr_db": [0.0, 30.0], "nonlinear": False, "channel": "awgn"},
    {"snr_db": [0.0, 30.0], "nonlinear": True, "channel": "awgn", "pa_saturation": 0.8,
     "pa_smoothness": 3.0, "iq_amplitude_db": 1.0, "iq_phase_deg": 5.0,
     "phase_noise_dbchz": -80.0, "sample_rate": 1e6},
]


@pytest.mark.parametrize("L", [16, 64])
@pytest.mark.parametrize("dg", DATAGEN, ids=["linear", "nonlinear"])
def test_batch_matches_the_ports_datagen_on_the_same_draws(dg, L):
    from ofdmgan_tpu_torch.ops.datagen_kernel import synthetic_batch_plain
    from ofdmgan_tpu_torch.signal.datagen import synthetic_batch_from_draws
    from perfbench.program import datagen_config
    gen = torch.Generator().manual_seed(5)
    draws = {k: torch.randn((6, L), generator=gen) for k in ("zr", "zi", "pn", "nr", "ni")}
    draws["u"] = torch.rand((6,), generator=gen)
    cfg = datagen_config({"frame_length": L}, {"datagen": dg})
    ref = {k: v.numpy() for k, v in ref_datagen.frames(draws, dg).items()}
    for port in (synthetic_batch_plain(draws, cfg), synthetic_batch_from_draws(draws, cfg)):
        for key in ("noisy", "clean"):
            np.testing.assert_allclose(port[key].double().numpy(), ref[key], rtol=0, atol=2e-6)
        np.testing.assert_allclose(port["snr"].double().numpy(), ref["snr"], rtol=1e-6)


TINY_FULL = {"name": "tiny_full", "family": "full", "frame_length": 64, "levels": 2,
             "base_channels": 4, "leaky_slope": 0.2}


def cases():
    mini, mini_cell = load("configs", "mini_pair"), load("workloads", "mini.gan.f32.b65536")
    full_cell = load("workloads", "full.gan.f32.b512")
    return [("mini", mini, {**mini_cell, "batch": 8}),
            ("full", TINY_FULL, {**full_cell, "batch": 3})]


def run_both(config, cell, reference_route, steps=3, dtype=torch.float64):
    """The port's step (``reference_route``: both routes plain) and the
    reference over ``steps`` steps in ``dtype`` on the same weights and
    draws."""
    weights = make_weights(config, 7, CPU)
    weights = {n: {k: v.to(dtype) for k, v in p.items()} for n, p in weights.items()}
    program = Program(config, cell, copy.deepcopy(weights), 7, CPU)
    program.generator.to(dtype)
    program.critic.to(dtype)
    program.step.reference = reference_route
    trainer = Trainer(config, cell["recipe"], weights)
    gen = torch.Generator().manual_seed(11)
    B, L = cell["batch"], config["frame_length"]
    out = []
    for _ in range(steps):
        normals = {k: torch.randn((B, L), generator=gen) for k in ("zr", "zi", "pn", "nr", "ni")}
        normals["u"] = torch.rand((B,), generator=gen)
        batch = {k: v.to(dtype) for k, v in check.reference_batch(
            {"normals": normals}, config, cell, CPU).items()}
        alphas = [torch.rand((B,), generator=gen, dtype=dtype)
                  for _ in range(cell["recipe"]["n_critic"])]
        p = program.step.run(batch, alphas)
        r = trainer.step(batch, alphas)
        out.append((p, r))
    return program, trainer, out, weights


def test_reference_step_matches_the_ports_plain_step_in_float64():
    """The mini pair in float64, where Adam's first updates (each entry
    +-lr by the sign of its gradient) are the same to the last bits."""
    _, config, cell = cases()[0]
    program, trainer, out, weights = run_both(config, cell, reference_route=True)
    for p, r in out:
        assert float(p["d_loss"]) == pytest.approx(r["d_loss"], rel=1e-6)
        assert float(p["g_loss"]) == pytest.approx(r["g_loss"], rel=1e-6)
    for module, params in ((program.generator, trainer.g), (program.critic, trainer.d)):
        for k, v in module.named_parameters():
            moved = (params[k] - v).abs().max().item()
            assert moved <= 1e-6 * cell["recipe"]["lr"], k


def assert_changes_agree(program, trainer, weights, tol):
    """Each leaf's change over the steps, by norm, as ``check.leaf_gap``
    takes it, within ``tol``."""
    for net, module, params in (("generator", program.generator, trainer.g),
                                ("critic", program.critic, trainer.d)):
        with torch.no_grad():
            prog = {k: float((v - weights[net][k]).norm()) for k, v in module.named_parameters()}
            ref = {k: float((v - weights[net][k]).norm()) for k, v in params.items()}
        keep = [k for k in ref if ref[k] > 0]
        assert check.leaf_gap(prog, ref, keep) <= tol, net


def test_reference_step_matches_the_mini_critic_kernels_plain_version():
    """The kernel route's plain version (float32 only) against the
    reference in float32."""
    _, mini, cell = cases()[0]
    program, trainer, out, weights = run_both(mini, cell, reference_route=False,
                                              dtype=torch.float32)
    assert program.step.critic_route == "kernel"
    for p, r in out:
        for key in ("d", "g"):
            gap = abs(float(p[f"{key}_loss"]) - r[f"{key}_loss"]) / r[f"{key}_scale"]
            assert gap <= 1e-5, (key, gap)
    assert_changes_agree(program, trainer, weights, 1e-2)


def test_reference_step_matches_the_full_pairs_plain_step_in_float32():
    """The full pair (its critic pools in float32 whatever its weights) at
    a tiny width in float32, held by the benchmark's own numbers."""
    _, config, cell = cases()[1]
    program, trainer, out, weights = run_both(config, cell, reference_route=True,
                                              dtype=torch.float32)
    for p, r in out:
        for key in ("d", "g"):
            gap = abs(float(p[f"{key}_loss"]) - r[f"{key}_loss"]) / r[f"{key}_scale"]
            assert gap <= 1e-5, (key, gap)
    assert_changes_agree(program, trainer, weights, 1e-2)


def test_the_reference_goes_on_from_a_copy_of_its_state():
    """A trainer built from another's parameters and Adam state after one
    step takes the same second step: what the checked chunk relies on."""
    _, config, cell = cases()[0]
    weights = make_weights(config, 9, CPU)
    gen = torch.Generator().manual_seed(3)
    B, L = cell["batch"], config["frame_length"]

    def draws():
        normals = {k: torch.randn((B, L), generator=gen) for k in ("zr", "zi", "pn", "nr", "ni")}
        normals["u"] = torch.rand((B,), generator=gen)
        batch = check.reference_batch({"normals": normals}, config, cell, CPU)
        return batch, [torch.rand((B,), generator=gen) for _ in range(cell["recipe"]["n_critic"])]

    first, second = draws(), draws()
    whole = Trainer(config, cell["recipe"], weights)
    whole.step(*first)
    state = {net: {"m": opt.m, "v": opt.v, "t": opt.t}
             for net, opt in (("generator", whole.opt_g), ("critic", whole.opt_d))}
    part = Trainer(config, cell["recipe"], {"generator": whole.g, "critic": whole.d}, adam=state)
    a, b = whole.step(*second), part.step(*second)
    assert (a["d_loss"], a["g_loss"]) == (b["d_loss"], b["g_loss"])
    for x, y in ((whole.g, part.g), (whole.d, part.d)):
        for k in x:
            assert torch.equal(x[k], y[k]), k
