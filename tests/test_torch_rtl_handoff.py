"""The port's RTL-residual handoff bundle (``python -m
ofdmgan_tpu_torch.make_rtl_handoff``) against the committed one, which
``scripts/make_rtl_handoff.py`` wrote from the committed ``rtl_qat``
champion.

The port regenerates every vector file, both ROM images and the
manifest's CRC32s byte for byte. Two lines name the program that wrote
them and differ by design: the manifest's engine
(``ofdmgan_tpu_torch/quant/intsim.py`` where the JAX package names its
own) and the ROM's generator comment (``rom_codegen``'s, as in
``tests/test_torch_quant.py``). The native engine fixsim agrees with every
regenerated expected output.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ofdmgan_tpu_torch import make_rtl_handoff
from ofdmgan_tpu_torch.quant.rom_codegen import GENERATED_BY, parse_rom_verilog
from ofdmgan_tpu_torch.verify import cosim
from ofdmgan_tpu_torch.verify.golden import read_hex
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
BUNDLE = REPO / "rtl" / "handoff_rtl_residual"
ROM = REPO / "rtl" / "weight_rom_rtl_residual.v"
CKPT = "results/residual_checkpoints/rtl_qat/champion_params_g.npz"


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    out = tmp_path_factory.mktemp("handoff")
    manifest = make_rtl_handoff.main(["--checkpoint", str(REPO / CKPT), "--out_dir",
                                      str(out / "bundle"), "--rom_file", str(out / "rom.v"),
                                      "--device", "cpu"])
    return out, manifest


def test_vectors_and_rom_images_are_byte_identical(regenerated):
    out, _ = regenerated
    committed = sorted(p.relative_to(BUNDLE) for p in BUNDLE.rglob("*") if p.is_file())
    ours = sorted(p.relative_to(out / "bundle") for p in (out / "bundle").rglob("*")
                  if p.is_file())
    assert ours == committed and len(committed) == 23
    for rel in committed:
        if rel.name != "manifest.json":
            assert (out / "bundle" / rel).read_bytes() == (BUNDLE / rel).read_bytes(), rel


def test_manifest_matches_but_for_the_engine(regenerated):
    out, manifest = regenerated
    want = json.loads((BUNDLE / "manifest.json").read_text())
    got = json.loads((out / "bundle" / "manifest.json").read_text())
    assert got == manifest
    assert got["engines_agreeing"] == make_rtl_handoff.ENGINES
    assert want["engines_agreeing"] == ["ofdmgan_tpu/quant/intsim.py:generator_int_forward",
                                        make_rtl_handoff.ENGINES[1]]
    got["checkpoint"] = CKPT
    got["engines_agreeing"] = want["engines_agreeing"]
    assert got == want
    # the CRC32s are those of the vector files' words
    for name, v in got["vectors"].items():
        words = read_hex(out / "bundle" / "vectors" / f"{name}_out.hex")
        assert v["out_range_q88"] == [int(words.min()), int(words.max())]


def test_rom_matches_but_for_its_generator(regenerated):
    out, _ = regenerated
    ours, committed = (out / "rom.v").read_text().splitlines(), ROM.read_text().splitlines()
    assert len(ours) == len(committed)
    differ = [i for i, (a, b) in enumerate(zip(ours, committed)) if a != b]
    assert differ == [1] and ours[1] == GENERATED_BY
    for a, b in zip(parse_rom_verilog(str(out / "rom.v")), parse_rom_verilog(str(ROM))):
        np.testing.assert_array_equal(a, b)


def test_fixsim_agrees_with_every_vector(regenerated):
    out, manifest = regenerated
    rom_w, rom_b = parse_rom_verilog(str(out / "rom.v"))
    for name in manifest["vectors"]:
        x = read_hex(out / "bundle" / "vectors" / f"{name}_in.hex").reshape(1, 2, 16)
        y = cosim.generator_forward(rom_w, rom_b, x, residual=True)
        np.testing.assert_array_equal(y.flatten(),
                                      read_hex(out / "bundle" / "vectors" / f"{name}_out.hex"))


def test_frames_match_the_script():
    from scripts.make_rtl_handoff import make_test_frames

    want = make_test_frames()
    got = make_rtl_handoff.make_test_frames()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_cli_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "ofdmgan_tpu_torch.make_rtl_handoff", "--checkpoint", CKPT,
         "--out_dir", str(tmp_path / "b"), "--rom_file", str(tmp_path / "rom.v"),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "10 vector pairs" in out.stdout
    assert (tmp_path / "b" / "vectors" / "ofdm_snr0_out.hex").read_bytes() == \
        (BUNDLE / "vectors" / "ofdm_snr0_out.hex").read_bytes()
