"""``bench_infer`` on the CPU at a tiny size: well-formed rows in the
reference's format with finite outputs, for both families, datagen in the
loop and resident, fused and unfused. On the CPU the datagen kernel's
wrapper runs its plain version, so no launch is counted and no idle share
is measured; the card's counts are gated by ``chip_smoke.py``."""

import json

import pytest
import torch

from ofdmgan_tpu_torch import bench_infer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KEYS = {"metric", "model", "value", "unit", "input", "vs_reference_fpga"}


@pytest.fixture(autouse=True)
def one_window_each(monkeypatch):
    monkeypatch.setattr(bench_infer, "WARMUP_WINDOWS", 1)
    monkeypatch.setattr(bench_infer, "TIMED_WINDOWS", 1)


@pytest.mark.parametrize("extra", [[], ["--resident"], ["--resident", "--unfused"]])
def test_rows_are_well_formed(capsys, extra):
    results = bench_infer.main(["--device", "cpu", "--batch", "64", "--scan_steps", "2",
                                *extra])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    stats, rows = lines[:2], lines[2:]
    assert [r["row"] for r in results] == rows and [r["stats"] for r in results] == stats
    resident = "--resident" in extra
    full = "full_unet_3.94Mp_L1024" + ("_unfused" if "--unfused" in extra else "")
    assert [r["model"] for r in rows] == ["mini_258p_L16", full]
    for row, st in zip(rows, stats):
        assert set(row) == KEYS | ({"us_per_apply"} if resident else set())
        assert row["metric"] == "generator_inference_frames_per_sec_per_chip"
        assert row["unit"] == "frames/s/chip" and row["value"] > 0
        assert row["input"] == st["input"] == ("resident" if resident else "datagen_in_loop")
        assert row["vs_reference_fpga"] == round(row["value"] / 1e5, 1)
        assert st["datagen_launches_per_window"] == 0 and st["idle_share"] is None
        assert st["window_ms"] > 0
    if resident:   # batch 64 over the window's time
        assert rows[0]["us_per_apply"] == pytest.approx(64 / rows[0]["value"] * 1e6, rel=1e-3)


def test_a_window_reads_the_chained_outputs():
    """The resident window's applies form one chain: each input is the base
    batch plus the last output's first entry times 1e-12."""
    seen = []

    def apply(x):
        seen.append(x.clone())
        return x * 0 + 3.0

    w = bench_infer.Window(apply, 4, 16, 3, True, torch.device("cpu"), torch.float32)
    assert w.run() == 3.0
    assert torch.equal(seen[0], w.base) and torch.equal(seen[1], w.base + 3.0 * 1e-12)
    assert all(torch.isfinite(s).all() for s in seen)


def test_unknown_models_are_refused():
    with pytest.raises(SystemExit):
        bench_infer.main(["--device", "cpu", "--models", "tiny"])
