"""The port's VCD parser, as-built RTL cycle model and testbench stimulus
against the JAX package's (``ofdmgan_tpu/verify/vcd.py``,
``ofdmgan_tpu/verify/rtl_cycle_model.py``, ``scripts/vcd_crosscheck.py``).

The reference's recorded Icarus dumps are not in the repository, so the
parser reads a dump this file writes in Icarus's format (nested scopes, an
aliased net, ``$dumpvars``, scalar, vector, x and real changes, a
comment) from a handshaked testbench of two test segments; both parsers
must give the same variables, posedge samples and transactions, and the
transactions must be the words written. The cycle models run the
testbenches' own stimulus on the committed ``rtl/weight_rom.v`` and on
random ROMs, word for word. Everything here is integer: equality is exact.
"""

from pathlib import Path

import numpy as np
import pytest

from ofdmgan_tpu.verify import rtl_cycle_model as j_rtl
from ofdmgan_tpu.verify import vcd as j_vcd
from ofdmgan_tpu_torch import vcd_crosscheck
from ofdmgan_tpu_torch.quant.rom_codegen import BIAS_DEPTH, WEIGHT_DEPTH, parse_rom_verilog
from ofdmgan_tpu_torch.verify import rtl_cycle_model as t_rtl
from ofdmgan_tpu_torch.verify import vcd as t_vcd
from scripts import vcd_crosscheck as script

REPO = Path(__file__).resolve().parents[1]

IDS = {"clk": "!", "rst_n": '"', "data_in": "#", "valid_in": "$", "ready_in": "%",
       "data_out": "&", "valid_out": "'", "ready_out": "(", "done": ")", "t_real": "*",
       "state": "+"}
WIDTHS = {"data_in": 16, "data_out": 16, "state": 8}


def _bin(v: int, width: int) -> str:
    return format(v & ((1 << width) - 1), "b")


def write_tb_vcd(path: Path, tests):
    """An Icarus-style dump of a handshaked testbench: for each (inputs,
    outputs) pair, 32 input words accepted while ``ready_in`` is high, then
    the DUT's registered outputs with ``valid_out`` and a ``done`` pulse."""
    lines = ["$date today $end", "$version Icarus Verilog $end", "$timescale 1ps $end",
             "$scope module tb $end"]
    for name in ("clk", "rst_n", "data_in", "valid_in", "ready_in", "data_out", "valid_out",
                 "ready_out", "done"):
        w = WIDTHS.get(name, 1)
        rng = f" [{w - 1}:0]" if w > 1 else ""
        lines.append(f"$var {'reg' if name in ('data_in', 'valid_in') else 'wire'} {w} "
                     f"{IDS[name]} {name}{rng} $end")
    lines += [f"$var real 1 {IDS['t_real']} t_real $end", "$scope module dut $end",
              f"$var wire 1 {IDS['clk']} clk $end", f"$var reg 8 {IDS['state']} state [7:0] $end",
              "$upscope $end", "$upscope $end", "$enddefinitions $end",
              "$comment written by a test $end", "#0", "$dumpvars", "0!", '0"', "bx #", "0$",
              "0%", "bx &", "0'", "1(", "0)", "r0 *", "b0 +", "$end"]
    t = 0
    cycle_changes = []   # the changes committed at each posedge

    def edge(*changes):
        cycle_changes.append(list(changes))

    edge('1"')   # out of reset
    edge("1%")   # the DUT raises ready_in
    for k, (x, y) in enumerate(tests):
        for i, v in enumerate(x):   # the tb drives a word on each edge ready_in is seen high
            edge(f"b{_bin(v, 16)} #", "1$", f"r{k + i / 32} *", f"b{_bin(i, 8)} +")
        edge("0$", "0%", "bx #")   # load done: the DUT drops ready_in
        edge("b10000000 +")
        edge("1'", f"b{_bin(y[0], 16)} &")
        for w in y[1:]:
            edge(f"b{_bin(w, 16)} &")
        edge("0'", "1)", "bx &")   # the last word is read on this edge; done rises
        edge("0)", "1%")           # the trailing edge closes the segment
        edge()
    for changes in cycle_changes:
        t += 5
        lines += [f"#{t}", "1!", *changes]
        t += 5
        lines += [f"#{t}", "0!"]
    path.write_text("\n".join(lines) + "\n")


def _tests():
    rng = np.random.default_rng(0)
    return [([int(v) for v in rng.integers(-32768, 32768, 32)],
             [int(v) for v in rng.integers(-32768, 32768, 32)]) for _ in range(2)]


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("vcd") / "tb.vcd"
    write_tb_vcd(path, _tests())
    return path


def test_header_matches_jax(dump):
    ours, theirs = t_vcd.VCD(str(dump)), j_vcd.VCD(str(dump))
    assert {k: (v.id_code, v.width) for k, v in ours.vars.items()} == \
        {k: (v.id_code, v.width) for k, v in theirs.vars.items()}
    assert ours.width_of("tb.data_out") == 16 and ours.id_of("tb.dut.clk") == IDS["clk"]
    with pytest.raises(KeyError):
        ours.id_of("tb.nothing")


def test_posedge_samples_match_jax(dump):
    tracked = {k: f"tb.{k}" for k in ("rst_n", "data_in", "valid_in", "ready_in", "data_out",
                                      "valid_out", "done")}
    tracked["state"] = "tb.dut.state"
    ours = list(t_vcd.VCD(str(dump)).posedge_samples("tb.clk", tracked))
    theirs = list(j_vcd.VCD(str(dump)).posedge_samples("tb.clk", tracked))
    assert ours == theirs and len(ours) == 2 + 2 * (32 + 2 + 32 + 2 + 1)
    assert ours[0][1]["rst_n"] == 0 and ours[0][2]["rst_n"] == 1
    assert ours[0][1]["data_in"] is None   # x before the first word


def test_transactions_match_jax_and_the_words_written(dump):
    kw = dict(in_streams=[j_vcd.Stream("data_in", "valid_in", "ready_in")], out_data="data_out",
              out_valid="valid_out", out_ready="ready_out", out_cap=32)
    theirs = j_vcd.extract_transactions(str(dump), "tb", **kw)
    kw["in_streams"] = [t_vcd.Stream("data_in", "valid_in", "ready_in")]
    ours = t_vcd.extract_transactions(str(dump), "tb", **kw)
    assert ours == theirs
    assert ours == [{"data_in": x, "data_out": y} for x, y in _tests()]


@pytest.mark.parametrize("value, width", [(0x7FFF, 16), (0x8000, 16), (0xFFFF, 16),
                                          (0x1FFFF, 16), (0x80, 8), (None, 16)])
def test_to_signed_matches_jax(value, width):
    assert t_vcd.to_signed(value, width) == j_vcd.to_signed(value, width)


def test_stimulus_matches_the_script():
    assert vcd_crosscheck.gen_tb_stimulus() == script.gen_tb_stimulus()
    assert vcd_crosscheck.disc_tb_stimulus() == script.disc_tb_stimulus()
    for frame in vcd_crosscheck.gen_tb_stimulus():
        np.testing.assert_array_equal(vcd_crosscheck.chmajor_to_blc(frame),
                                      script.chmajor_to_blc(frame))


def _rom(name):
    if name == "weight_rom.v":
        return parse_rom_verilog(str(REPO / "rtl" / "weight_rom.v"))
    rng = np.random.default_rng(int(name[-1]))
    return rng.integers(-128, 128, WEIGHT_DEPTH), rng.integers(-2048, 2048, BIAS_DEPTH)


@pytest.mark.parametrize("rom", ["weight_rom.v", "random1", "random2"])
def test_cycle_models_match_jax(rom):
    rom_w, rom_b = _rom(rom)
    ours, theirs = t_rtl.GeneratorMiniRTL(rom_w, rom_b), j_rtl.GeneratorMiniRTL(rom_w, rom_b)
    outs = []
    for frame in vcd_crosscheck.gen_tb_stimulus():   # back to back on one DUT, as recorded
        out = ours.run_frame(frame)
        assert out == theirs.run_frame(frame)
        outs.append(out)
    assert all(len(o) == 32 for o in outs) and any(any(o) for o in outs)
    ours = t_rtl.DiscriminatorMiniRTL(rom_w, rom_b)
    theirs = j_rtl.DiscriminatorMiniRTL(rom_w, rom_b)
    for cand, cond in vcd_crosscheck.disc_tb_stimulus():
        assert ours.run_pair(cand, cond) == theirs.run_pair(cand, cond)


def test_crosscheck_without_the_dumps_fails_and_names_them(tmp_path, capsys):
    (tmp_path / "weight_rom.v").write_text((REPO / "rtl" / "weight_rom.v").read_text())
    rc = vcd_crosscheck.main(["--rtl_dir", str(tmp_path), "--device", "cpu",
                              "--output", str(tmp_path / "r.json")])
    err = capsys.readouterr().err
    assert rc == 2 and "tb_generator_mini.vcd" in err and "tb_discriminator_mini.vcd" in err
    assert "weight_rom.v," not in err and not (tmp_path / "r.json").exists()
