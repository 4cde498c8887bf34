"""On the card, at the cells' own sizes: the datagen kernel's Philox stream
against the reference's batch from the same seed; the lower-precision
control (TF32 allowed) failing a number that sound runs pass; and whole
runs with a fault planted under the timed path coming out not correct.
Run on the card with ``python3 -m pytest perfbench/tests -m cuda``."""

import numpy as np
import pytest
import torch

from perfbench import calibrate, check, run, spec
from perfbench.faults import FAULTS

CELLS = ["mini.gan.f32.b65536", "full.gan.f32.b512"]
SEEDS = (5000000001, 5000000002, 5000000003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_datagen_kernels_stream_is_the_references(card, cell):
    from ofdmgan_tpu_torch.ops import datagen_kernel
    from perfbench.program import datagen_config
    s = spec.cell(cell)
    config, c = s["config"], s["cell"]
    B, L = c["batch"], config["frame_length"]
    seed = 2 ** 61 + 12345
    fn, args, out = datagen_kernel.prepare(datagen_config(config, c), B, card,
                                           torch.tensor([seed], dtype=torch.int64, device=card),
                                           None)
    assert fn(*args) == 0
    ref = check.reference_batch({"seed": seed}, config, c, card)
    for key in ("noisy", "clean"):
        err = (out[key] - ref[key]).abs()
        assert float(err.max()) < 1e-4, key
        assert float(err.mean()) < 1e-6, key


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_number_that_sound_runs_pass(card, cell):
    limits = spec.cell(cell)["cell"]["limits"]
    for seed in SEEDS:
        sound = calibrate.reading(cell, seed, "sound", card)
        assert all(sound[k] <= limits[k] for k in limits), sound
        control = calibrate.reading(cell, seed, "control", card)
        assert "error" in control or any(control[k] > limits[k] for k in limits), control


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_comes_out_not_correct_at_the_cells_size(card, cell, fault):
    line = run.run_cell(cell, 5000000004, 1.0, False, fault=fault)
    assert line["correct"] is False
    assert np.isfinite(line["metrics"]["train_frames_per_s"]["value"])
