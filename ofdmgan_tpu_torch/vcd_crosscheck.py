"""Cross-check the bit-true engines against the reference RTL's own recorded
execution: ``python -m ofdmgan_tpu_torch.vcd_crosscheck --rtl_dir DIR``
(counterpart of ``scripts/vcd_crosscheck.py``, with the dump directory and
the report as flags).

``--rtl_dir`` (default ``rtl/ofdmGAN``, where the reference's RTL
directory lands once it is in the repository) holds the reference's
``weight_rom.v`` and the Icarus
Verilog dumps of its own testbench runs, ``tb_generator_mini.vcd`` and
``tb_discriminator_mini.vcd`` (written by the ``$dumpvars`` blocks,
tb_generator_mini.v:122-126). They record the actual RTL executing under
its author's simulator with that ROM. The check:

  1. parses the ROM (``quant/rom_codegen.parse_rom_verilog``) and unpacks
     it into integer parameters (``unpack_rom_arrays``);
  2. recovers every testbench transaction from the dumps
     (``verify/vcd.extract_transactions``): 10 generator tests of 32-sample
     frames, 5 critic tests of (candidate, condition) frames;
  3. recomputes the testbench stimulus (all 15 tests are deterministic,
     tb_generator_mini.v:213-434, tb_discriminator_mini.v:177-249) and
     requires the extracted inputs to equal it, which pins the dumps'
     timing conventions;
  4. checks every ROM read the RTL performed (the dumps hold the weight and
     bias ROM address and data buses) against the parsed ROM;
  5. replays the recorded inputs through the as-built cycle model
     (``verify/rtl_cycle_model.py``), which must match EVERY recorded
     output word;
  6. replays them through ``quant/intsim.py`` (on ``--device``) and
     ``native/fixsim.cpp``, which implement the *documented* datapath: they
     are expected to diverge from the as-built RTL (registered-ROM weight
     skew, counter carry-over between states, partial stages); the
     divergence is recorded and the two engines must agree with each
     other.

Writes ``--output`` (a JSON report). Exit code 0 iff every required check
passes; where a file of ``--rtl_dir`` is missing it exits 2 and names it.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

RTL_DIR = "rtl/ofdmGAN"
DUMPS = ("weight_rom.v", "tb_generator_mini.vcd", "tb_discriminator_mini.vcd")
PI = 3.14159  # the testbenches' literal, not math.pi
L = 16


def _rtoi(x: float) -> int:
    """Verilog $rtoi: truncate toward zero."""
    return int(x)


def _vdiv(a: int, b: int) -> int:
    """Verilog signed integer division: truncate toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def gen_tb_stimulus():
    """The 10 generator-testbench input frames (channel-major, 32 ints),
    recomputed from tb_generator_mini.v:213-434."""
    tests = []
    # 1 zero / 2 DC / 3 impulse
    tests.append([0] * 32)
    tests.append([0x80] * 32)
    tests.append([0x100 if i in (8, 24) else 0 for i in range(32)])
    # 4 sine
    t = [_rtoi(100.0 * math.sin(2.0 * PI * i / L)) for i in range(L)]
    t += [_rtoi(100.0 * math.cos(2.0 * PI * i / L)) for i in range(L)]
    tests.append(t)
    # 5 ramp
    tests.append([(i - 8) * 16 for i in range(L)] +
                 [(8 - i) * 16 for i in range(L)])
    # 6 QAM-4 (4 QPSK subcarriers)
    t = [_rtoi(64.0 * (math.cos(2 * PI * 2 * i / L) + math.cos(2 * PI * 4 * i / L)
                       - math.cos(2 * PI * 6 * i / L) - math.cos(2 * PI * 8 * i / L)))
         for i in range(L)]
    t += [_rtoi(64.0 * (math.sin(2 * PI * 2 * i / L) - math.sin(2 * PI * 4 * i / L)
                        + math.sin(2 * PI * 6 * i / L) - math.sin(2 * PI * 8 * i / L)))
          for i in range(L)]
    tests.append(t)
    # 7 noisy OFDM (deterministic LFSR-like noise)
    ci = [_rtoi(100.0 * math.cos(2 * PI * 4 * i / L)) for i in range(L)]
    cq = [_rtoi(100.0 * math.sin(2 * PI * 4 * i / L)) for i in range(L)]
    tests.append([ci[i] + ((i * 73 + 13) % 64) - 32 for i in range(L)] +
                 [cq[i] + ((i * 37 + 7) % 64) - 32 for i in range(L)])
    # 8 frequency-selective fade
    ci = [_rtoi(100.0 * (math.cos(2 * PI * 3 * i / L) + math.cos(2 * PI * 5 * i / L)))
          for i in range(L)]
    cq = [_rtoi(100.0 * (math.sin(2 * PI * 3 * i / L) + math.sin(2 * PI * 5 * i / L)))
          for i in range(L)]
    g = [192 + _rtoi(64.0 * math.cos(2 * PI * i / L)) for i in range(L)]
    tests.append([_vdiv(ci[i] * g[i], 256) for i in range(L)] +
                 [_vdiv(cq[i] * g[i], 256) for i in range(L)])
    # 9 16-QAM
    tests.append(
        [_rtoi(40.0 * (((i % 4) * 2) - 3) * math.cos(2 * PI * 2 * i / L))
         for i in range(L)] +
        [_rtoi(40.0 * ((((i + 1) % 4) * 2) - 3) * math.sin(2 * PI * 2 * i / L))
         for i in range(L)])
    # 10 burst error (deep fade samples 6-10)
    ci = [_rtoi(100.0 * math.cos(2 * PI * 3 * i / L)) for i in range(L)]
    cq = [_rtoi(100.0 * math.sin(2 * PI * 3 * i / L)) for i in range(L)]
    tests.append([_vdiv(ci[i], 8) if 6 <= i <= 10 else ci[i] for i in range(L)] +
                 [_vdiv(cq[i], 8) if 6 <= i <= 10 else cq[i] for i in range(L)])
    return tests


def disc_tb_stimulus():
    """The 5 discriminator-testbench (candidate, condition) frames
    (tb_discriminator_mini.v:177-249)."""
    s = [_rtoi(100.0 * math.sin(2.0 * PI * i / L)) for i in range(L)]
    c = [_rtoi(100.0 * math.cos(2.0 * PI * i / L)) for i in range(L)]
    tests = [([0] * 32, [0] * 32)]
    tests.append((s + c, s + c))
    tests.append((s + c, [-v for v in s] + [-v for v in c]))
    tests.append((
        [((i * 73 + 17) % 256) - 128 for i in range(L)]
        + [((i * 37 + 91) % 256) - 128 for i in range(L)],
        [((i * 41 + 53) % 256) - 128 for i in range(L)]
        + [((i * 59 + 23) % 256) - 128 for i in range(L)]))
    tests.append(([0x80] * 32, [0x80] * 32))
    return tests


def chmajor_to_blc(flat32) -> np.ndarray:
    """[32] channel-major (16 x I then 16 x Q) -> [16, 2] channels-last."""
    a = np.asarray(flat32, np.int32).reshape(2, L)
    return a.T.copy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Replay the reference RTL's recorded runs")
    ap.add_argument("--rtl_dir", default=RTL_DIR,
                    help="directory of weight_rom.v, tb_generator_mini.vcd and "
                         "tb_discriminator_mini.vcd")
    ap.add_argument("--output", default="build/vcd_crosscheck.json", help="JSON report")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu, for intsim")
    args = ap.parse_args(argv)

    import torch

    from .device import resolve_device
    from .quant import intsim
    from .quant.rom_codegen import parse_rom_verilog, unpack_rom_arrays
    from .verify import cosim
    from .verify.rtl_cycle_model import DiscriminatorMiniRTL, GeneratorMiniRTL
    from .verify.vcd import VCD, Stream, extract_transactions, to_signed

    dev = resolve_device(args.device)
    rtl = Path(args.rtl_dir)
    missing = [str(rtl / name) for name in DUMPS if not (rtl / name).is_file()]
    if missing:
        print(f"vcd_crosscheck: missing {', '.join(missing)}: nothing was checked",
              file=sys.stderr)
        return 2
    report = {"rom": str(rtl / "weight_rom.v"), "checks": {}, "divergence": {}}
    ok = True

    def record(name, passed, **details):
        nonlocal ok
        ok &= bool(passed)
        report["checks"][name] = {"pass": bool(passed), **details}
        print(f"  [{'PASS' if passed else 'FAIL'}] {name} "
              + (f"{details}" if not passed else ""))

    def on_device(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)

    rom_w, rom_b = parse_rom_verilog(str(rtl / "weight_rom.v"))
    gen_ip, disc_ip = unpack_rom_arrays(rom_w, rom_b)

    # ------------- ROM bus cross-check (both dumps) -------------
    for tb in ("tb_generator_mini", "tb_discriminator_mini"):
        vcd = VCD(str(rtl / f"{tb}.vcd"))
        tracked = {}
        for k in range(3):
            tracked[f"wa{k}"] = f"{tb}.dut.weight_addr_k{k}"
            tracked[f"wk{k}"] = f"{tb}.dut.weight_k{k}"
        tracked["ba"] = f"{tb}.dut.bias_addr"
        tracked["bd"] = f"{tb}.dut.bias_data"
        w_reads, b_reads, w_bad, b_bad = 0, 0, 0, 0
        for _, pre, post in vcd.posedge_samples(f"{tb}.clk", tracked):
            for k in range(3):
                a, d = pre.get(f"wa{k}"), post.get(f"wk{k}")
                if a is not None and d is not None:
                    w_reads += 1
                    w_bad += int(to_signed(d, 8) != int(rom_w[a]))
            a, d = pre.get("ba"), post.get("bd")
            if a is not None and d is not None:
                b_reads += 1
                b_bad += int(to_signed(d, 16) != int(rom_b[a]))
        record(f"{tb}_rom_reads_match_parsed", w_bad == 0 and b_bad == 0,
               weight_reads=w_reads, bias_reads=b_reads,
               weight_mismatches=w_bad, bias_mismatches=b_bad)

    # ---------------- generator ----------------
    print("generator: tb_generator_mini.vcd")
    tests = extract_transactions(
        str(rtl / "tb_generator_mini.vcd"), "tb_generator_mini",
        [Stream("data_in", "valid_in", "ready_in")],
        "data_out", "valid_out", "ready_out", out_cap=32)
    record("gen_test_count", len(tests) == 10, found=len(tests))
    stim = gen_tb_stimulus()
    n = min(len(tests), 10)
    in_ok = all(tests[t]["data_in"] == stim[t] for t in range(n))
    record("gen_inputs_match_recomputed_stimulus", in_ok,
           first_mismatch=next((t for t in range(n)
                                if tests[t]["data_in"] != stim[t]), None))
    shapes_ok = all(len(tests[t]["data_out"]) == 32 for t in range(n))
    record("gen_output_counts", shapes_ok,
           counts=[len(t["data_out"]) for t in tests])

    x = np.stack([chmajor_to_blc(tests[t]["data_in"]) for t in range(n)])
    rtl_out = np.stack([chmajor_to_blc(tests[t]["data_out"]) for t in range(n)])

    # as-built cycle model: must be bit-exact (tests share one DUT
    # instance back-to-back, as in the recorded run)
    gmodel = GeneratorMiniRTL(rom_w, rom_b)
    cyc_out = np.stack([chmajor_to_blc(gmodel.run_frame(tests[t]["data_in"]))
                        for t in range(n)])
    record("gen_cycle_model_bitexact", np.array_equal(cyc_out, rtl_out),
           mismatches=int(np.sum(cyc_out != rtl_out)))

    # documented-datapath engines: record the divergence from the
    # as-built RTL, and require the two engines to agree with each other
    int_out = intsim.generator_int_forward(gen_ip, on_device(x), mode="rtl").cpu().numpy()
    cpp_out = cosim.generator_forward(
        rom_w.astype(np.int8), rom_b.astype(np.int16),
        np.swapaxes(x, 1, 2).astype(np.int16))
    cpp_out = np.swapaxes(cpp_out, 1, 2).astype(np.int32)
    record("gen_intsim_fixsim_agree", np.array_equal(int_out, cpp_out))
    report["divergence"]["generator_documented_vs_asbuilt"] = {
        "mismatching_words": int(np.sum(int_out != rtl_out)),
        "total_words": int(rtl_out.size),
        "max_abs_delta_q88": int(np.max(np.abs(int_out - rtl_out))),
        "note": "expected: the as-built RTL does not compute the "
                "documented datapath (see verify/rtl_cycle_model.py)",
    }
    print(f"  [INFO] documented vs as-built generator: "
          f"{int(np.sum(int_out != rtl_out))}/{rtl_out.size} words differ")

    # ---------------- discriminator ----------------
    print("discriminator: tb_discriminator_mini.vcd")
    dtests = extract_transactions(
        str(rtl / "tb_discriminator_mini.vcd"), "tb_discriminator_mini",
        [Stream("cand_in", "cand_valid", "ready_in"),
         Stream("cond_in", "cond_valid", "ready_in")],
        "score_out", "score_valid", None)
    record("disc_test_count", len(dtests) == 5, found=len(dtests))
    dstim = disc_tb_stimulus()
    m = min(len(dtests), 5)
    din_ok = all(dtests[t]["cand_in"] == dstim[t][0]
                 and dtests[t]["cond_in"] == dstim[t][1] for t in range(m))
    record("disc_inputs_match_recomputed_stimulus", din_ok,
           first_mismatch=next(
               (t for t in range(m)
                if dtests[t]["cand_in"] != dstim[t][0]
                or dtests[t]["cond_in"] != dstim[t][1]), None))
    rtl_scores = np.array([dtests[t]["score_out"][-1] for t in range(m)],
                          np.int32)

    cand = np.stack([chmajor_to_blc(dtests[t]["cand_in"]) for t in range(m)])
    cond = np.stack([chmajor_to_blc(dtests[t]["cond_in"]) for t in range(m)])

    dmodel = DiscriminatorMiniRTL(rom_w, rom_b)
    cyc_scores = np.array(
        [dmodel.run_pair(dtests[t]["cand_in"], dtests[t]["cond_in"])
         for t in range(m)], np.int32)
    record("disc_cycle_model_bitexact",
           np.array_equal(cyc_scores, rtl_scores),
           rtl=rtl_scores.tolist(), ours=cyc_scores.tolist())

    int_scores = intsim.discriminator_int_forward(
        disc_ip, on_device(cand), on_device(cond), mode="rtl")[:, 0].cpu().numpy()
    cpp_scores = cosim.discriminator_forward(
        rom_w.astype(np.int8), rom_b.astype(np.int16),
        np.swapaxes(cand, 1, 2).astype(np.int16),
        np.swapaxes(cond, 1, 2).astype(np.int16)).astype(np.int32)
    record("disc_intsim_fixsim_agree",
           np.array_equal(int_scores, cpp_scores))
    report["divergence"]["discriminator_documented_vs_asbuilt"] = {
        "rtl_scores": rtl_scores.tolist(),
        "documented_datapath_scores": int_scores.tolist(),
        "note": "the as-built critic returns a constant (4 x dense bias) "
                "regardless of input — see rtl_cycle_model.py",
    }
    print(f"  [INFO] as-built critic scores {rtl_scores.tolist()} vs "
          f"documented-datapath {int_scores.tolist()}")

    report["ok"] = ok
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(f"{'ALL BIT-EXACT' if ok else 'MISMATCHES FOUND'} -> {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
