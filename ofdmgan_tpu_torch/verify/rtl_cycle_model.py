"""Cycle-accurate behavioral model of the reference's AS-BUILT RTL: the
port's own copy of ``ofdmgan_tpu/verify/rtl_cycle_model.py``. It models
registers cycle by cycle in plain Python, so it has no device.

Why this exists: quant/intsim.py and native/fixsim.cpp implement the
reference RTL's *documented* datapath (the per-tap ``>>>7`` Q1.7 MACs,
slope-0.3125 LeakyReLU, clamp-tanh — generator_mini.v:141-146, 359-361,
630-648). Replaying the reference's own checked-in Icarus Verilog dumps
(``python -m ofdmgan_tpu_torch.vcd_crosscheck``) showed the actual RTL
produces *different numbers*: the hardware's FSM has cycle-level
behaviors its comments do not describe. This module models the RTL at the register-transfer level
— every nonblocking assignment, ROM read latency, and counter wrap — so
that its outputs can be compared word-for-word against the recorded
simulation, proving we understand the as-built hardware exactly.

As-built behaviors this model reproduces (none are in intsim's "rtl"
mode, which implements the documented intent; all were confirmed against
tb_generator_mini.vcd / tb_discriminator_mini.vcd):

  * **Registered-ROM skew**: ``weight_rom``/``bias_rom`` reads are
    registered (weight_rom.v:164-165, 260-261) but the MAC pipeline
    fetches data and weights in the same stage (generator_mini.v:332-336)
    — so every product multiplies sample ``x[iter k]`` by the weights of
    iteration ``k-1``, and the first iteration of each layer uses
    whatever the ROM happened to be holding (the previous layer's last
    weights, or reset zeros).
  * **Counter carry-over between states**: ``out_ch_cnt``/``out_pos_cnt``
    /``in_ch_iter``/``pipe_flush`` are reset only in
    ST_IDLE/ST_LOAD_IN (generator_mini.v:314-321). Each subsequent stage
    inherits the previous stage's final counters, so e.g. the bottleneck
    starts at out_ch 3 (its channels 0-2 are never computed and stay at
    reset zero), UPSAMPLE1 copies only channel 7, SKIP_ADD adds the skip
    connection only to channel 3, and the tanh clamp is applied only to
    channel 1 (confirmed by the recorded bias_rom address trace: 4..6
    never appear on the bus).
  * **Pipe-flush wrap-around**: ``pipe_flush`` is 3 bits and only ever
    incremented inside conv states, so a stage entered with
    ``pipe_flush==3`` re-sweeps its (pos, iter) space until the counter
    wraps back to 2 — re-writing its last channel several times with the
    skewed weights.
  * **Out-of-range memory semantics**: reads/writes with out-of-range
    indices (possible during the carried-over sweeps) behave like
    Verilog memories — writes are discarded; reads would return x (the
    model asserts they never feed a stored value, which holds on every
    recorded test).

This is a verification artifact (the rebuild's stand-in for running
iverilog on the reference's own files), not part of the compute path:
the deployable integer story remains intsim/fixsim + our regenerated
ROMs, which implement the *intended* datapath self-consistently.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _wrap(v: int, bits: int) -> int:
    """Unsigned wrap to ``bits`` (Verilog reg counter semantics)."""
    return v & ((1 << bits) - 1)


def _swrap(v: int, bits: int) -> int:
    """Signed wrap to ``bits`` (Verilog signed reg assignment)."""
    mask = (1 << bits) - 1
    v &= mask
    return (v ^ (1 << (bits - 1))) - (1 << (bits - 1))


def _sra(v: int, n: int) -> int:
    """Verilog ``>>>`` on a signed value (Python ``>>`` is arithmetic)."""
    return v >> n


def _lrelu16(r: int) -> int:
    """generator_mini.v:358-361 — if (result[15]) (r>>>2)+(r>>>4)."""
    if r < 0:
        return _swrap(_sra(r, 2) + _sra(r, 4), 16)
    return r


def _sat_store(sum32: int) -> int:
    """The saturate-to-int16 idiom of every *_store block."""
    if sum32 > 0x7FFF:
        return 0x7FFF
    if sum32 < -0x8000:
        return -0x8000
    return _swrap(sum32, 16)


class GeneratorMiniRTL:
    """Cycle model of generator_mini.v (677 lines, FSM at :84-95)."""

    # localparams (generator_mini.v:61-79)
    IN_CH, OUT_CH, FRAME_LEN = 2, 2, 16
    ENC1_OUT_CH, ENC1_OUT_LEN = 4, 8
    BNECK_OUT_CH, BNECK_OUT_LEN = 8, 4
    DEC1_OUT_CH, DEC1_OUT_LEN = 4, 8
    WADDR_ENC1, WADDR_BNECK, WADDR_DEC1, WADDR_OUT = 0, 24, 120, 216
    BADDR_ENC1, BADDR_BNECK, BADDR_DEC1, BADDR_OUT = 0, 4, 12, 16
    (IDLE, LOAD_IN, ENC1, BNECK, UPSAMPLE1, DEC1, SKIP_ADD, UPSAMPLE2,
     OUT_CONV, TANH, OUTPUT, DONE) = range(12)

    def __init__(self, rom_weights: Sequence[int], rom_biases: Sequence[int]):
        self.rom_w = [int(v) for v in rom_weights]  # Q1.7 int8, depth 2048
        self.rom_b = [int(v) for v in rom_biases]   # Q8.8 int16, depth 64
        self.reset()

    def reset(self) -> None:
        self.state = self.IDLE
        # buffers, with the RTL's padding slots (generator_mini.v:101-109)
        self.input_buf = [[0] * (self.FRAME_LEN + 2) for _ in range(self.IN_CH)]
        self.skip_buf = [[0] * self.ENC1_OUT_LEN for _ in range(self.ENC1_OUT_CH)]
        self.enc1_buf = [[0] * (self.ENC1_OUT_LEN + 2) for _ in range(self.ENC1_OUT_CH)]
        self.bneck_buf = [[0] * self.BNECK_OUT_LEN for _ in range(self.BNECK_OUT_CH)]
        self.up1_buf = [[0] * (self.ENC1_OUT_LEN + 2) for _ in range(self.BNECK_OUT_CH)]
        self.dec1_buf = [[0] * self.DEC1_OUT_LEN for _ in range(self.DEC1_OUT_CH)]
        self.up2_buf = [[0] * self.FRAME_LEN for _ in range(self.DEC1_OUT_CH)]
        self.out_buf = [[0] * self.FRAME_LEN for _ in range(self.OUT_CH)]
        # ROM interface registers (addr regs + registered read data)
        self.wab = 0            # weight_addr_base
        self.bias_addr = 0
        self.wk = [0, 0, 0]     # weight_k0/1/2 (registered ROM outputs)
        self.bias_data = 0
        # MAC pipeline registers
        self.data_k = [0, 0, 0]
        self.s2_valid = 0
        self.s2_oc = self.s2_op = 0
        self.s2_last = 0
        self.s3_valid = 0
        self.s3_oc = self.s3_op = 0
        self.s3_last = 0
        self.s3_ksum = 0
        self.accum = [0] * 16
        # counters
        self.in_ch = self.in_pos = 0
        self.oc = self.op = self.ic = 0
        self.flush = 0
        # output interface
        self.data_out = 0
        self.valid_out = 0

    # ------------------------------------------------------------------
    def _next_state(self, start: int, valid_in: int, ready_out: int) -> int:
        """Combinational next_state (generator_mini.v:188-241)."""
        s = self.state
        if s == self.IDLE:
            return self.LOAD_IN if start else s
        if s == self.LOAD_IN:
            if (self.in_ch == self.IN_CH - 1
                    and self.in_pos == self.FRAME_LEN - 1 and valid_in):
                return self.ENC1
        elif s == self.ENC1:
            if (self.oc == self.ENC1_OUT_CH - 1 and self.op == self.ENC1_OUT_LEN - 1
                    and self.ic == self.IN_CH - 1 and self.flush == 2):
                return self.BNECK
        elif s == self.BNECK:
            if (self.oc == self.BNECK_OUT_CH - 1 and self.op == self.BNECK_OUT_LEN - 1
                    and self.ic == self.ENC1_OUT_CH - 1 and self.flush == 2):
                return self.UPSAMPLE1
        elif s == self.UPSAMPLE1:
            if self.oc == self.BNECK_OUT_CH - 1 and self.op == self.BNECK_OUT_LEN - 1:
                return self.DEC1
        elif s == self.DEC1:
            if (self.oc == self.DEC1_OUT_CH - 1 and self.op == self.DEC1_OUT_LEN - 1
                    and self.ic == self.BNECK_OUT_CH - 1 and self.flush == 2):
                return self.SKIP_ADD
        elif s == self.SKIP_ADD:
            if self.oc == self.DEC1_OUT_CH - 1 and self.op == self.DEC1_OUT_LEN - 1:
                return self.UPSAMPLE2
        elif s == self.UPSAMPLE2:
            if self.oc == self.DEC1_OUT_CH - 1 and self.op == self.DEC1_OUT_LEN - 1:
                return self.OUT_CONV
        elif s == self.OUT_CONV:
            if (self.oc == self.OUT_CH - 1 and self.op == self.FRAME_LEN - 1
                    and self.ic == self.DEC1_OUT_CH - 1 and self.flush == 2):
                return self.TANH
        elif s == self.TANH:
            if self.oc == self.OUT_CH - 1 and self.op == self.FRAME_LEN - 1:
                return self.OUTPUT
        elif s == self.OUTPUT:
            if (self.in_ch == self.OUT_CH - 1
                    and self.in_pos == self.FRAME_LEN - 1 and ready_out):
                return self.DONE
        elif s == self.DONE:
            return self.IDLE
        return s

    # ------------------------------------------------------------------
    def step(self, start: int = 0, valid_in: int = 0, data_in: int = 0,
             ready_out: int = 1) -> None:
        """One posedge: every nonblocking assignment evaluated from the
        pre-edge register values and committed atomically."""
        s = self.state
        nxt: Dict[str, object] = {}
        nxt["state"] = self._next_state(start, valid_in, ready_out)

        # ---- ROM registered reads (weight_rom.v:164-165, 260-261) ----
        nxt["wk"] = [self.rom_w[_wrap(self.wab + k, 11)] for k in range(3)]
        nxt["bias_data"] = self.rom_b[_wrap(self.bias_addr, 6)]

        # ---- input loading / ST_OUTPUT position counter (:246-276) ----
        if s == self.IDLE and start:
            nxt["in_ch"], nxt["in_pos"] = 0, 0
            nxt["input_clear"] = True
        elif s == self.LOAD_IN and valid_in:
            nxt["input_write"] = (self.in_ch, self.in_pos + 1,
                                  _swrap(data_in, 16))
            if self.in_pos == self.FRAME_LEN - 1:
                nxt["in_pos"] = 0
                nxt["in_ch"] = _wrap(self.in_ch + 1, 3)
            else:
                nxt["in_pos"] = self.in_pos + 1
        elif s == self.OUTPUT and ready_out:
            if self.in_pos == self.FRAME_LEN - 1:
                nxt["in_pos"] = 0
                nxt["in_ch"] = _wrap(self.in_ch + 1, 3)
            else:
                nxt["in_pos"] = self.in_pos + 1

        # ---- output streaming (:658-668) ----
        if s == self.OUTPUT:
            ch, pos = self.in_ch, self.in_pos
            if ch < self.OUT_CH and pos < self.FRAME_LEN:
                nxt["data_out"] = self.out_buf[ch][pos]
            nxt["valid_out"] = 1
        else:
            nxt["valid_out"] = 0

        # ---- conv/aux pipeline (:283-653) ----
        kernel_sum = sum(
            _sra(_swrap(self.data_k[k] * self.wk[k], 24), 7) for k in range(3))
        kernel_sum = _swrap(kernel_sum, 32)

        if s in (self.IDLE, self.LOAD_IN):
            nxt.update(oc=0, op=0, ic=0, flush=0, s2_valid=0, s3_valid=0)
            nxt["accum_clear"] = True
        elif s in (self.ENC1, self.BNECK, self.DEC1, self.OUT_CONV):
            self._conv_state(s, nxt, kernel_sum)
        elif s == self.UPSAMPLE1:
            nxt.update(s2_valid=0, s3_valid=0, flush=0)
            nxt["accum_clear"] = True
            if self.oc < self.BNECK_OUT_CH and self.op < self.BNECK_OUT_LEN:
                v = self.bneck_buf[self.oc][self.op]
                nxt["up1_write"] = (self.oc, self.op * 2 + 1, v)
            if self.op == self.BNECK_OUT_LEN - 1:
                nxt["op"] = 0
                nxt["oc"] = 0 if self.oc == self.BNECK_OUT_CH - 1 \
                    else _wrap(self.oc + 1, 4)
            else:
                nxt["op"] = self.op + 1
        elif s == self.SKIP_ADD:
            nxt.update(s2_valid=0, s3_valid=0, flush=0)
            nxt["accum_clear"] = True
            if self.oc < self.DEC1_OUT_CH and self.op < self.DEC1_OUT_LEN:
                total = (self.dec1_buf[self.oc][self.op]
                         + self.skip_buf[self.oc][self.op])
                nxt["dec1_write"] = (self.oc, self.op, _sat_store(total))
            if self.op == self.DEC1_OUT_LEN - 1:
                nxt["op"] = 0
                nxt["oc"] = 0 if self.oc == self.DEC1_OUT_CH - 1 \
                    else _wrap(self.oc + 1, 4)
            else:
                nxt["op"] = self.op + 1
        elif s == self.UPSAMPLE2:
            if self.oc < self.DEC1_OUT_CH and self.op < self.DEC1_OUT_LEN:
                v = self.dec1_buf[self.oc][self.op]
                nxt["up2_write"] = (self.oc, self.op * 2, v)
            if self.op == self.DEC1_OUT_LEN - 1:
                nxt["op"] = 0
                nxt["oc"] = 0 if self.oc == self.DEC1_OUT_CH - 1 \
                    else _wrap(self.oc + 1, 4)
            else:
                nxt["op"] = self.op + 1
        elif s == self.TANH:
            nxt.update(s2_valid=0, s3_valid=0, flush=0)
            if self.oc < self.OUT_CH and self.op < self.FRAME_LEN:
                v = self.out_buf[self.oc][self.op]
                if v > 0x100:
                    nxt["out_write"] = (self.oc, self.op, 0x00FF)
                elif v < -0x100:
                    nxt["out_write"] = (self.oc, self.op, -0x00FF)
            if self.op == self.FRAME_LEN - 1:
                nxt["op"] = 0
                if self.oc == self.OUT_CH - 1:
                    nxt["in_ch"], nxt["in_pos"] = 0, 0
                nxt["oc"] = _wrap(self.oc + 1, 4)  # unconditional (:645)
            else:
                nxt["op"] = self.op + 1

        self._commit(nxt)

    # ------------------------------------------------------------------
    def _conv_state(self, s: int, nxt: Dict[str, object],
                    kernel_sum: int) -> None:
        """The shared shape of ST_ENC1/ST_BNECK/ST_DEC1/ST_OUT_CONV."""
        F = self.FRAME_LEN
        if s == self.ENC1:
            src, ic_n, oc_n, op_n = self.input_buf, self.IN_CH, \
                self.ENC1_OUT_CH, self.ENC1_OUT_LEN
            waddr = self.WADDR_ENC1 + self.oc * (self.IN_CH * 3) + self.ic * 3
            baddr = self.BADDR_ENC1 + self.oc
            fetch = [(self.ic, self.op * 2 + k) for k in range(3)]
        elif s == self.BNECK:
            src, ic_n, oc_n, op_n = self.enc1_buf, self.ENC1_OUT_CH, \
                self.BNECK_OUT_CH, self.BNECK_OUT_LEN
            waddr = self.WADDR_BNECK + self.oc * (self.ENC1_OUT_CH * 3) + self.ic * 3
            baddr = self.BADDR_BNECK + self.oc
            fetch = [(self.ic, self.op * 2 + k) for k in range(3)]
            # first-cycle pipe clear (:393-396) — only if counters are clean
            if self.oc == 0 and self.op == 0 and self.ic == 0 and self.flush == 0:
                nxt.update(s2_valid=0, s3_valid=0)
                nxt["accum_clear"] = True
        elif s == self.DEC1:
            src, ic_n, oc_n, op_n = self.up1_buf, self.BNECK_OUT_CH, \
                self.DEC1_OUT_CH, self.DEC1_OUT_LEN
            waddr = self.WADDR_DEC1 + self.oc * (self.BNECK_OUT_CH * 3) + self.ic * 3
            baddr = self.BADDR_DEC1 + self.oc
            fetch = [(self.ic, self.op + k) for k in range(3)]
        else:  # OUT_CONV, k=1
            src, ic_n, oc_n, op_n = self.up2_buf, self.DEC1_OUT_CH, \
                self.OUT_CH, F
            waddr = self.WADDR_OUT + self.oc * self.DEC1_OUT_CH + self.ic
            baddr = self.BADDR_OUT + self.oc
            fetch = [(self.ic, self.op)]
            kernel_sum = _sra(_swrap(self.data_k[0] * self.wk[0], 24), 7)

        # Stage 1: address + data fetch (registered)
        nxt["wab"] = _wrap(waddr, 11)
        nxt["bias_addr"] = _wrap(baddr, 6)
        dk = list(self.data_k)
        for k, (ci, pi) in enumerate(fetch):
            assert 0 <= ci < len(src) and 0 <= pi < len(src[0]), \
                f"x-propagating OOB read in state {s}: [{ci}][{pi}]"
            dk[k] = src[ci][pi]
        nxt["data_k"] = dk
        nxt["s2_valid"] = 1
        nxt["s2_oc"], nxt["s2_op"] = self.oc, self.op
        nxt["s2_last"] = int(self.ic == ic_n - 1)
        # Stage 2 -> 3
        nxt["s3_valid"] = self.s2_valid
        nxt["s3_oc"], nxt["s3_op"] = self.s2_oc, self.s2_op
        nxt["s3_last"] = self.s2_last
        nxt["s3_ksum"] = kernel_sum
        # Stage 3: accumulate / store
        if self.s3_valid:
            a = _wrap(self.s3_oc, 4)
            if self.s3_last:
                total = _swrap(self.accum[a] + self.s3_ksum + self.bias_data, 32)
                r = _sat_store(total)
                if s != self.OUT_CONV:
                    r = _lrelu16(r)
                if s == self.ENC1:
                    nxt["enc1_write"] = (self.s3_oc, self.s3_op + 1, r)
                    nxt["skip_write"] = (self.s3_oc, self.s3_op, r)
                elif s == self.BNECK:
                    nxt["bneck_write"] = (self.s3_oc, self.s3_op, r)
                elif s == self.DEC1:
                    nxt["dec1_write"] = (self.s3_oc, self.s3_op, r)
                else:
                    nxt["out_write"] = (self.s3_oc, self.s3_op, r)
                nxt["accum_write"] = (a, 0)
            else:
                nxt["accum_write"] = (a, _swrap(self.accum[a] + self.s3_ksum, 32))
        # counter advancement
        if self.ic == ic_n - 1:
            nxt["ic"] = 0
            if self.op == op_n - 1:
                nxt["op"] = 0
                if self.oc == oc_n - 1:
                    nxt["flush"] = _wrap(self.flush + 1, 3)
                else:
                    nxt["oc"] = _wrap(self.oc + 1, 4)
            else:
                nxt["op"] = _wrap(self.op + 1, 5)
        else:
            nxt["ic"] = _wrap(self.ic + 1, 4)

    # ------------------------------------------------------------------
    def _commit(self, nxt: Dict[str, object]) -> None:
        def buf_write(buf: List[List[int]], key: str) -> None:
            if key in nxt:
                ch, pos, v = nxt[key]  # type: ignore[misc]
                if 0 <= ch < len(buf) and 0 <= pos < len(buf[0]):
                    buf[ch][pos] = v  # in-range only: Verilog OOB writes drop

        if nxt.pop("input_clear", False):
            for row in self.input_buf:
                row[:] = [0] * len(row)
        if nxt.pop("accum_clear", False):
            # RTL source order: the for-loop clear precedes the stage-3
            # accumulate in the same always block, so a same-edge
            # accum_write overrides the clear for its index only.
            self.accum = [0] * 16
        buf_write(self.input_buf, "input_write")
        buf_write(self.enc1_buf, "enc1_write")
        buf_write(self.skip_buf, "skip_write")
        buf_write(self.bneck_buf, "bneck_write")
        buf_write(self.up1_buf, "up1_write")
        buf_write(self.dec1_buf, "dec1_write")
        buf_write(self.up2_buf, "up2_write")
        buf_write(self.out_buf, "out_write")
        if "up1_write" in nxt:  # UPSAMPLE1 writes two slots (:470-471)
            ch, pos, v = nxt["up1_write"]  # type: ignore[misc]
            if 0 <= ch < len(self.up1_buf) and 0 <= pos + 1 < len(self.up1_buf[0]):
                self.up1_buf[ch][pos + 1] = v
        if "up2_write" in nxt:  # UPSAMPLE2 writes two slots (:563-564)
            ch, pos, v = nxt["up2_write"]  # type: ignore[misc]
            if 0 <= ch < len(self.up2_buf) and 0 <= pos + 1 < len(self.up2_buf[0]):
                self.up2_buf[ch][pos + 1] = v
        if "accum_write" in nxt:
            a, v = nxt["accum_write"]  # type: ignore[misc]
            self.accum[a] = v
        for key in ("state", "wk", "bias_data", "wab", "bias_addr", "data_k",
                    "s2_valid", "s2_oc", "s2_op", "s2_last", "s3_valid",
                    "s3_oc", "s3_op", "s3_last", "s3_ksum", "in_ch", "in_pos",
                    "oc", "op", "ic", "flush", "data_out", "valid_out"):
            if key in nxt:
                setattr(self, key, nxt[key])

    # ------------------------------------------------------------------
    def run_frame(self, samples: Sequence[int],
                  max_cycles: int = 20000) -> List[int]:
        """Drive one testbench transaction (tb_generator_mini.v:483-600):
        start pulse, stream the 32 channel-major samples, run to DONE,
        return the 32 channel-major output words."""
        assert len(samples) == self.IN_CH * self.FRAME_LEN
        # idle settle, then a 1-cycle start pulse
        for _ in range(3):
            self.step()
        self.step(start=1)
        idx = 0
        for _ in range(max_cycles):
            if self.state == self.LOAD_IN and idx < len(samples):
                self.step(valid_in=1, data_in=int(samples[idx]))
                idx += 1
            else:
                self.step()
            if self.state == self.DONE:
                break
        else:
            raise RuntimeError("generator cycle model did not reach DONE")
        out = [self.out_buf[c][p] for c in range(self.OUT_CH)
               for p in range(self.FRAME_LEN)]
        # return to IDLE for the next frame (state only; buffers persist,
        # as in the RTL — LOAD_IN clears what matters)
        self.step()
        return out


class DiscriminatorMiniRTL:
    """Cycle model of discriminator_mini.v (513 lines, FSM at :80-89).

    As-built behaviors beyond the generator's (same registered-ROM skew
    and counter carry-over): ST_CONV2 inherits out_ch 7 from CONV1's
    final counters so channels 0-6 are never computed
    (discriminator_mini.v:365-367 clear guard fails), ST_POOL inherits
    out_ch 15 and pools ONLY channel 15 (:432-436), and ST_DENSE's exit
    counter increments pipe_flush every cycle once out_ch==15 (:476-479)
    while pipe_s2_last stays 1, so the last channel's ksum + bias are
    re-accumulated on every flush-wait cycle — with the checked-in ROM
    this makes the score a constant -4 (4 x dense bias) for every input,
    which is exactly what the recorded testbench run shows.
    """

    IN_CH, FRAME_LEN = 4, 16
    CONV1_OUT_CH, CONV1_OUT_LEN = 8, 8
    CONV2_OUT_CH, CONV2_OUT_LEN = 16, 4
    WADDR_CONV1, WADDR_CONV2, WADDR_DENSE = 256, 352, 736
    BADDR_CONV1, BADDR_CONV2, BADDR_DENSE = 32, 40, 56
    (IDLE, LOAD_CAND, LOAD_COND, CONV1, CONV2, POOL, DENSE, OUTPUT,
     DONE) = range(9)

    def __init__(self, rom_weights, rom_biases):
        self.rom_w = [int(v) for v in rom_weights]
        self.rom_b = [int(v) for v in rom_biases]
        self.reset()

    def reset(self) -> None:
        self.state = self.IDLE
        self.input_buf = [[0] * (self.FRAME_LEN + 2) for _ in range(self.IN_CH)]
        self.conv1_buf = [[0] * (self.CONV1_OUT_LEN + 2)
                          for _ in range(self.CONV1_OUT_CH)]
        self.conv2_buf = [[0] * self.CONV2_OUT_LEN
                          for _ in range(self.CONV2_OUT_CH)]
        self.pool_buf = [0] * self.CONV2_OUT_CH
        self.wab = 0
        self.bias_addr = 0
        self.wk = [0, 0, 0]
        self.bias_data = 0
        self.data_k = [0, 0, 0]
        self.s2_valid = self.s2_oc = self.s2_op = self.s2_last = 0
        self.s3_valid = self.s3_oc = self.s3_op = self.s3_last = 0
        self.s3_ksum = 0
        self.accum = [0] * 16
        self.dense_acc = 0
        self.load_ch = self.load_pos = 0
        self.oc = self.op = self.ic = 0
        self.flush = 0
        self.score_out = 0
        self.score_valid = 0

    def _next_state(self, start, cand_valid, cond_valid):
        s = self.state
        if s == self.IDLE:
            return self.LOAD_CAND if start else s
        if s == self.LOAD_CAND:
            if self.load_ch == 1 and self.load_pos == self.FRAME_LEN - 1 \
                    and cand_valid:
                return self.LOAD_COND
        elif s == self.LOAD_COND:
            if self.load_ch == 1 and self.load_pos == self.FRAME_LEN - 1 \
                    and cond_valid:
                return self.CONV1
        elif s == self.CONV1:
            if (self.oc == self.CONV1_OUT_CH - 1
                    and self.op == self.CONV1_OUT_LEN - 1
                    and self.ic == self.IN_CH - 1 and self.flush == 2):
                return self.CONV2
        elif s == self.CONV2:
            if (self.oc == self.CONV2_OUT_CH - 1
                    and self.op == self.CONV2_OUT_LEN - 1
                    and self.ic == self.CONV1_OUT_CH - 1 and self.flush == 2):
                return self.POOL
        elif s == self.POOL:
            if (self.oc == self.CONV2_OUT_CH - 1
                    and self.op == self.CONV2_OUT_LEN - 1):
                return self.DENSE
        elif s == self.DENSE:
            if self.oc == self.CONV2_OUT_CH - 1 and self.flush == 2:
                return self.OUTPUT
        elif s == self.OUTPUT:
            return self.DONE
        elif s == self.DONE:
            return self.IDLE
        return s

    def step(self, start=0, cand_valid=0, cand_in=0, cond_valid=0,
             cond_in=0) -> None:
        s = self.state
        nxt: Dict[str, object] = {"state": self._next_state(
            start, cand_valid, cond_valid)}
        nxt["wk"] = [self.rom_w[_wrap(self.wab + k, 11)] for k in range(3)]
        nxt["bias_data"] = self.rom_b[_wrap(self.bias_addr, 6)]

        # ---- loading (:220-255) ----
        if s == self.IDLE and start:
            nxt["load_ch"], nxt["load_pos"] = 0, 0
            nxt["input_clear"] = True
        elif s == self.LOAD_CAND and cand_valid:
            nxt["input_write"] = (self.load_ch, self.load_pos + 1,
                                  _swrap(cand_in, 16))
            if self.load_pos == self.FRAME_LEN - 1:
                nxt["load_pos"] = 0
                nxt["load_ch"] = 0 if self.load_ch == 1 \
                    else _wrap(self.load_ch + 1, 2)
            else:
                nxt["load_pos"] = self.load_pos + 1
        elif s == self.LOAD_COND and cond_valid:
            nxt["input_write"] = (self.load_ch + 2, self.load_pos + 1,
                                  _swrap(cond_in, 16))
            if self.load_pos == self.FRAME_LEN - 1:
                nxt["load_pos"] = 0
                nxt["load_ch"] = _wrap(self.load_ch + 1, 2)
            else:
                nxt["load_pos"] = self.load_pos + 1

        # ---- score output (:489-505) ----
        if s == self.OUTPUT:
            nxt["score_out"] = _sat_store(self.dense_acc)
            nxt["score_valid"] = 1
        else:
            nxt["score_valid"] = 0

        kernel_sum = _swrap(sum(
            _sra(_swrap(self.data_k[k] * self.wk[k], 24), 7)
            for k in range(3)), 32)

        if s in (self.IDLE, self.LOAD_CAND, self.LOAD_COND):
            nxt.update(oc=0, op=0, ic=0, flush=0, s2_valid=0, s3_valid=0,
                       dense_acc=0)
            nxt["accum_clear"] = True
            nxt["pool_clear"] = True
        elif s in (self.CONV1, self.CONV2):
            if s == self.CONV1:
                src, ic_n, oc_n, op_n = self.input_buf, self.IN_CH, \
                    self.CONV1_OUT_CH, self.CONV1_OUT_LEN
                waddr = self.WADDR_CONV1 + self.oc * (self.IN_CH * 3) \
                    + self.ic * 3
                baddr = self.BADDR_CONV1 + self.oc
            else:
                src, ic_n, oc_n, op_n = self.conv1_buf, self.CONV1_OUT_CH, \
                    self.CONV2_OUT_CH, self.CONV2_OUT_LEN
                waddr = self.WADDR_CONV2 + self.oc * (self.CONV1_OUT_CH * 3) \
                    + self.ic * 3
                baddr = self.BADDR_CONV2 + self.oc
                if (self.oc == 0 and self.op == 0 and self.ic == 0
                        and self.flush == 0):
                    nxt.update(s2_valid=0, s3_valid=0)
                    nxt["accum_clear"] = True
            nxt["wab"] = _wrap(waddr, 11)
            nxt["bias_addr"] = _wrap(baddr, 6)
            dk = list(self.data_k)
            for k in range(3):
                ci, pi = self.ic, self.op * 2 + k
                assert 0 <= ci < len(src) and 0 <= pi < len(src[0]), \
                    f"x-propagating OOB read in disc state {s}"
                dk[k] = src[ci][pi]
            nxt["data_k"] = dk
            nxt["s2_valid"] = 1
            nxt["s2_oc"], nxt["s2_op"] = self.oc, self.op
            nxt["s2_last"] = int(self.ic == ic_n - 1)
            nxt["s3_valid"] = self.s2_valid
            nxt["s3_oc"], nxt["s3_op"] = self.s2_oc, self.s2_op
            nxt["s3_last"] = self.s2_last
            nxt["s3_ksum"] = kernel_sum
            if self.s3_valid:
                a = _wrap(self.s3_oc, 4)
                if self.s3_last:
                    total = _swrap(
                        self.accum[a] + self.s3_ksum + self.bias_data, 32)
                    r = _lrelu16(_sat_store(total))
                    if s == self.CONV1:
                        nxt["conv1_write"] = (self.s3_oc, self.s3_op + 1, r)
                    else:
                        nxt["conv2_write"] = (self.s3_oc, self.s3_op, r)
                    nxt["accum_write"] = (a, 0)
                else:
                    nxt["accum_write"] = (
                        a, _swrap(self.accum[a] + self.s3_ksum, 32))
            if self.ic == ic_n - 1:
                nxt["ic"] = 0
                if self.op == op_n - 1:
                    nxt["op"] = 0
                    if self.oc == oc_n - 1:
                        nxt["flush"] = _wrap(self.flush + 1, 3)
                    else:
                        nxt["oc"] = _wrap(self.oc + 1, 5)
                else:
                    nxt["op"] = _wrap(self.op + 1, 5)
            else:
                nxt["ic"] = _wrap(self.ic + 1, 5)
        elif s == self.POOL:
            nxt.update(s2_valid=0, s3_valid=0, flush=0)
            if self.oc < self.CONV2_OUT_CH and self.op < self.CONV2_OUT_LEN:
                nxt["pool_write"] = (self.oc, _swrap(
                    self.pool_buf[self.oc] + self.conv2_buf[self.oc][self.op],
                    32))
            if self.op == self.CONV2_OUT_LEN - 1:
                nxt["op"] = 0
                nxt["oc"] = 0 if self.oc == self.CONV2_OUT_CH - 1 \
                    else _wrap(self.oc + 1, 5)
            else:
                nxt["op"] = self.op + 1
        elif s == self.DENSE:
            nxt["wab"] = _wrap(self.WADDR_DENSE + self.oc, 11)
            nxt["bias_addr"] = _wrap(self.BADDR_DENSE, 6)
            if self.oc < self.CONV2_OUT_CH:
                nxt["data_k"] = [_swrap(self.pool_buf[self.oc], 16),
                                 self.data_k[1], self.data_k[2]]
            nxt["s2_valid"] = 1
            nxt["s2_oc"] = self.oc
            nxt["s2_last"] = int(self.oc == self.CONV2_OUT_CH - 1)
            nxt["s3_valid"] = self.s2_valid
            nxt["s3_oc"] = self.s2_oc
            nxt["s3_last"] = self.s2_last
            nxt["s3_ksum"] = _sra(_swrap(self.data_k[0] * self.wk[0], 24), 7)
            if self.s3_valid:
                if self.s3_last:  # second assignment wins (:468-472)
                    nxt["dense_acc"] = _swrap(
                        self.dense_acc + self.s3_ksum + self.bias_data, 32)
                else:
                    nxt["dense_acc"] = _swrap(
                        self.dense_acc + self.s3_ksum, 32)
            if self.oc == self.CONV2_OUT_CH - 1:
                nxt["flush"] = _wrap(self.flush + 1, 3)
            else:
                nxt["oc"] = _wrap(self.oc + 1, 5)

        self._commit(nxt)

    def _commit(self, nxt: Dict[str, object]) -> None:
        def buf_write(buf, key):
            if key in nxt:
                ch, pos, v = nxt[key]
                if 0 <= ch < len(buf) and 0 <= pos < len(buf[0]):
                    buf[ch][pos] = v

        if nxt.pop("input_clear", False):
            for row in self.input_buf:
                row[:] = [0] * len(row)
        if nxt.pop("accum_clear", False):
            self.accum = [0] * 16
        if nxt.pop("pool_clear", False):
            self.pool_buf = [0] * self.CONV2_OUT_CH
        buf_write(self.input_buf, "input_write")
        buf_write(self.conv1_buf, "conv1_write")
        buf_write(self.conv2_buf, "conv2_write")
        if "pool_write" in nxt:
            ch, v = nxt["pool_write"]
            if 0 <= ch < len(self.pool_buf):
                self.pool_buf[ch] = v
        if "accum_write" in nxt:
            a, v = nxt["accum_write"]
            self.accum[a] = v
        for key in ("state", "wk", "bias_data", "wab", "bias_addr", "data_k",
                    "s2_valid", "s2_oc", "s2_op", "s2_last", "s3_valid",
                    "s3_oc", "s3_op", "s3_last", "s3_ksum", "dense_acc",
                    "load_ch", "load_pos", "oc", "op", "ic", "flush",
                    "score_out", "score_valid"):
            if key in nxt:
                setattr(self, key, nxt[key])

    def run_pair(self, cand: Sequence[int], cond: Sequence[int],
                 max_cycles: int = 20000) -> int:
        """Drive one (candidate, condition) transaction per
        tb_discriminator_mini.v:290-410; returns the registered score."""
        assert len(cand) == 32 and len(cond) == 32
        for _ in range(3):
            self.step()
        self.step(start=1)
        ci = di = 0
        score = None
        for _ in range(max_cycles):
            if self.state == self.LOAD_CAND and ci < 32:
                self.step(cand_valid=1, cand_in=int(cand[ci]))
                ci += 1
            elif self.state == self.LOAD_COND and di < 32:
                self.step(cond_valid=1, cond_in=int(cond[di]))
                di += 1
            else:
                self.step()
            if self.score_valid:
                score = self.score_out
            if self.state == self.DONE:
                break
        else:
            raise RuntimeError("discriminator cycle model did not reach DONE")
        self.step()
        return score
