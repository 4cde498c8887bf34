"""The harness past its look for a card: whole runs on the CPU at a small
batch (the kernels' plain versions, eager chunks), sound and with a fault
planted under the timed path; and its refusals. The same runs at the
cells' own sizes on the card are in ``test_perfbench_cuda.py``."""

import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import run, spec
from perfbench.faults import FAULTS

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SMALL = {"mini.gan.f32.b65536": {"batch": 64, "chunk": {"kind": "eager", "steps": 2}},
         "full.gan.f32.b512": {"batch": 2}}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_on_the_cpu_gives_finite_numbers(cell):
    line = run.run_cell(cell, 2 ** 31 + 11, 0.2, False, device=CPU, overrides=SMALL[cell])
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert {"train_frames_per_s", "setup_s"} <= set(line["metrics"])
    compared = spec.cell(cell)["cell"]["limits"]
    for k in compared:
        assert math.isfinite(line["checks"][k]["value"])


def test_a_supervised_recipe_runs_with_the_same_harness():
    """n_critic 0: the critic is never updated, on either side."""
    recipe = {"n_critic": 0, "gp_weight": 10.0, "adv_weight": 0.0, "rec_weight": 100.0,
              "lr": 0.0002, "betas": [0.0, 0.9]}
    line = run.run_cell("full.gan.f32.b512", 2 ** 31 + 13, 0.2, False, device=CPU,
                        overrides={"batch": 2, "recipe": recipe})
    assert line["failed"] == 0
    assert line["checks"]["critic_grad_gap"]["value"] == 0.0
    assert line["checks"]["loss_gap"]["value"] < 1e-3


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_planted_fault_comes_out_not_correct(cell, fault):
    line = run.run_cell(cell, 2 ** 31 + 12, 0.2, False, device=CPU, overrides=SMALL[cell],
                        fault=fault)
    assert line["correct"] is False
    failing = [k for k, v in line["checks"].items()
               if isinstance(v["limit"], float) and not v["value"] <= v["limit"]]
    assert failing, line["checks"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "mini.gan.f32.b65536", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    port is missing, and the run fails with no result line."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "mini.gan.f32.b65536", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_a_chunk_that_draws_stale_numbers_fails_only_the_chunk_numbers(monkeypatch):
    """A chunk whose steps draw again the numbers of the call before (the
    generator's state put back, as a graph whose draws were frozen at its
    capture would do): the checked steps, which precede the chunk, pass;
    the checked chunk fails."""
    from ofdmgan_tpu_torch.training import chunks
    call = chunks.EagerChunk.__call__

    def stale(self):
        before = getattr(self, "before", None)
        self.before = self.rng.get_state()
        if before is not None:
            self.rng.set_state(before)
        return call(self)

    monkeypatch.setattr(chunks.EagerChunk, "__call__", stale)
    cell = "mini.gan.f32.b65536"
    line = run.run_cell(cell, 2 ** 31 + 14, 0.2, False, device=CPU, overrides=SMALL[cell])
    assert line["correct"] is False
    compared = {k: v for k, v in line["checks"].items() if isinstance(v["limit"], float)}
    assert all(v["value"] <= v["limit"] for k, v in compared.items()
               if not k.startswith("chunk_"))
    assert any(v["value"] > v["limit"] for k, v in compared.items() if k.startswith("chunk_"))
