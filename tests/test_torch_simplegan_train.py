"""The port's simpleGAN learns, through its CLI (``python -m
ofdmgan_tpu_torch.simplegan.train_cli``) on the CPU.

The learning bar is the JAX package's (``tests/test_simplegan.py:34-50``):
after the recipe's 30,000 steps, 64 generated images lie at a mean
squared distance under 0.60 from the nearer of the two patterns (the
reference's own checked-in trained weights score 0.586; an untrained
generator about 1.0). The CLI draws from a CPU generator seeded
``--seed`` (default 0) on every device, and the samples here come from a
CPU generator seeded 2, as in ``chip_smoke.py``. Each 30,000-step run
takes some 14 s (``matlab``) and 25-30 s (``exact``) on one core.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ofdmgan_tpu_torch import simplegan as sg
from ofdmgan_tpu_torch.simplegan import train_cli
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
FILE_LINES = {"gen_w1.txt": 6, "gen_b1.txt": 3, "gen_w2.txt": 27, "gen_b2.txt": 9,
              "disc_w1.txt": 27, "disc_b1.txt": 3, "disc_w2.txt": 3, "disc_b2.txt": 1}


def mean_pattern_distance(params, n: int = 64) -> float:
    imgs = sg.generate_samples(params, ngs=torch.randn(
        n, 2, generator=torch.Generator().manual_seed(2))).reshape(n, 9)
    d = ((imgs[:, None] - sg.patterns()[None]) ** 2).mean(-1).min(1).values
    return float(d.mean())


@pytest.mark.parametrize("grad_mode", ["matlab", "exact"])
def test_cli_learns_the_patterns_in_30000_steps(tmp_path, grad_mode):
    params, losses = train_cli.main(["--device", "cpu", "--grad_mode", grad_mode,
                                     "--output_dir", str(tmp_path)])
    assert losses["loss_d"].shape == (30_000,)
    assert bool(torch.isfinite(losses["loss_d"]).all() and torch.isfinite(losses["loss_g"]).all())
    assert mean_pattern_distance(params) < 0.60
    assert {f: len((tmp_path / f).read_text().splitlines()) for f in FILE_LINES} == FILE_LINES


def test_cli_subprocess_at_a_few_hundred_steps(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "ofdmgan_tpu_torch.simplegan.train_cli", "--device", "cpu",
         "--steps", "300", "--seed", "3", "--output_dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "Trained 300 steps on cpu" in out.stdout
    assert {f: len((tmp_path / f).read_text().splitlines()) for f in FILE_LINES} == FILE_LINES
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert "matplotlib is not installed" in out.stdout
    else:
        assert (tmp_path / "generated_samples.png").exists()
        assert (tmp_path / "loss_curve.png").exists()
    # the weights written load back within a quantization step of a rerun's
    again = sg.load_weights_txt(str(tmp_path))
    params, _ = train_cli.main(["--device", "cpu", "--steps", "300", "--seed", "3",
                                "--output_dir", str(tmp_path / "again")])
    for field, a, b in zip(params._fields, params, again):
        step = 1 / 128 if field.startswith("w") else 1 / 256
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=step / 2 + 1e-7)
