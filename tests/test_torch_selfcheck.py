"""The port's selfcheck (``python -m ofdmgan_tpu_torch.selfcheck``) on the
CPU: every check passes under the JAX package's names, the kernel
statistics are skipped (the kernel runs on the GPU), no kernel launches,
and the ``--json`` artifact names torch and the device."""

import json
import subprocess
import sys
from pathlib import Path

from ofdmgan_tpu_torch import selfcheck

REPO = Path(__file__).resolve().parents[1]
NAMES = ["signal", "models", "training", "quant", "equalizers", "native-cosim",
         "pallas-datagen"]


def test_cli_passes_on_the_cpu(tmp_path):
    out = subprocess.run([sys.executable, "-m", "ofdmgan_tpu_torch.selfcheck", "--device",
                          "cpu", "--json", str(tmp_path / "sc.json")],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ALL PASSED" in out.stdout and "skipped on cpu" in out.stdout
    for name in NAMES:
        assert f"[PASS] {name}" in out.stdout
    report = json.loads((tmp_path / "sc.json").read_text())
    assert list(report) == NAMES + ["_meta"]
    assert all(report[n]["status"] == "pass" for n in NAMES)
    assert all(report[n]["launches"] == {"datagen": 0, "critic_grad": 0} for n in NAMES)
    assert "measured" not in report["pallas-datagen"]
    assert report["training"]["measured"]["routes"] == {"datagen": "kernel", "critic": "kernel"}
    meta = report["_meta"]
    assert meta["device"] == "cpu" and meta["ok"] and "torch" in meta and "jax" not in meta


def test_a_failed_check_fails_the_run(monkeypatch, capsys):
    def broken(dev):
        raise RuntimeError("fixsim did not build")

    monkeypatch.setitem(selfcheck.CHECKS, "native-cosim", broken)
    assert selfcheck.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] native-cosim" in out and "FAILURES PRESENT" in out
