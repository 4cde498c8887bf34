"""Minimal VCD (Value Change Dump) parser + RTL-testbench transaction
extractor: the port's own copy of ``ofdmgan_tpu/verify/vcd.py`` (plain
Python, no device).

Purpose: close the last epistemic gap on the "bit-true" claim. The two
integer engines — ``quant/intsim.py`` and ``native/fixsim.cpp`` (C++) —
are independent implementations, but both encode the *same author's
reading* of the reference Verilog (rtl/ofdmGAN/generator_mini.v,
discriminator_mini.v); a shared misreading would pass their cosim. The
reference repo, however, checks in Icarus Verilog waveform dumps from its
own testbench runs (rtl/ofdmGAN/tb_generator_mini.vcd etc., produced by
the ``$dumpvars(0, tb)`` blocks at tb_generator_mini.v:122-126). Those
dumps record the ACTUAL RTL executing under the reference author's own
simulator — evidence that cannot share a misreading with any
re-implementation.

This module parses the port-level transactions (handshaked input samples,
valid output samples) out of those dumps so that
``python -m ofdmgan_tpu_torch.vcd_crosscheck`` can replay the recorded
inputs through both engines and compare outputs bit-for-bit against the
recorded RTL outputs.

Scope: the subset of VCD emitted by Icarus Verilog — ``$scope``/``$var``
header, ``#<time>`` steps, scalar (``0!``), vector (``b1010 !``) and real
(``r1.5 !``) changes, and ``$dumpvars`` initial-value blocks. Timing
semantics used by the extractor (see ``posedge_samples``): all changes
recorded at a timestamp are committed atomically at that timestamp; for
every rising edge of the clock we expose both the pre-commit and the
post-commit snapshot, because a testbench that *blocking-assigns* inputs
in response to the edge makes the DUT see the post values (the recorded
runs complete, which pins that scheduling), while a testbench that
*reads* DUT outputs at the edge sees the pre values (non-blocking updates
land after the active region).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple


def to_signed(value: Optional[int], width: int) -> Optional[int]:
    """Two's-complement reinterpretation of a raw VCD vector value."""
    if value is None:
        return None
    mask = (1 << width) - 1
    value &= mask
    sign = 1 << (width - 1)
    return (value ^ sign) - sign


@dataclass
class _Var:
    id_code: str
    width: int


class VCD:
    """Parsed VCD header + lazily replayable change stream."""

    def __init__(self, path: str):
        self.path = Path(path)
        #: full hierarchical name -> _Var (aliased nets share an id code)
        self.vars: Dict[str, _Var] = {}
        self._body_offset = 0
        self._parse_header()

    def _parse_header(self) -> None:
        scope: List[str] = []
        with open(self.path, "r", errors="replace") as f:
            while True:
                line = f.readline()
                if not line:
                    raise ValueError(f"{self.path}: no $enddefinitions found")
                tok = line.split()
                if not tok:
                    continue
                if tok[0] == "$scope":
                    scope.append(tok[2])
                elif tok[0] == "$upscope":
                    scope.pop()
                elif tok[0] == "$var":
                    # $var <type> <width> <id> <name> [\[msb:lsb\]] $end
                    width = int(tok[2])
                    id_code = tok[3]
                    name = tok[4]
                    full = ".".join(scope + [name])
                    self.vars[full] = _Var(id_code, width)
                elif tok[0] == "$enddefinitions":
                    self._body_offset = f.tell()
                    return

    def id_of(self, name: str) -> str:
        if name in self.vars:
            return self.vars[name].id_code
        raise KeyError(f"{self.path}: no VCD variable named {name!r}")

    def width_of(self, name: str) -> int:
        return self.vars[name].width

    def posedge_samples(
        self, clk_name: str, tracked: Dict[str, str]
    ) -> Iterator[Tuple[int, Dict[str, Optional[int]], Dict[str, Optional[int]]]]:
        """Yield ``(time, pre, post)`` at every rising edge of ``clk_name``.

        ``tracked`` maps output keys -> full VCD variable names. ``pre``
        holds the tracked values in force immediately before the edge's
        timestamp commits; ``post`` holds them after all same-timestamp
        changes commit. Unknown (x/z) values are ``None``.
        """
        clk_id = self.id_of(clk_name)
        by_id: Dict[str, List[str]] = {}
        for key, name in tracked.items():
            by_id.setdefault(self.id_of(name), []).append(key)
        watch = set(by_id) | {clk_id}

        cur: Dict[str, Optional[int]] = {i: None for i in watch}
        pending: Dict[str, Optional[int]] = {}

        def snapshot() -> Dict[str, Optional[int]]:
            out: Dict[str, Optional[int]] = {}
            for i, keys in by_id.items():
                for k in keys:
                    out[k] = cur[i]
            return out

        def commit(time: int):
            if not pending:
                return None
            edge = (
                clk_id in pending
                and cur[clk_id] == 0
                and pending[clk_id] == 1
            )
            result = None
            if edge:
                pre = snapshot()
                cur.update(pending)
                result = (time, pre, snapshot())
            else:
                cur.update(pending)
            pending.clear()
            return result

        time = 0
        with open(self.path, "r", errors="replace") as f:
            f.seek(self._body_offset)
            for line in f:
                c = line[0] if line else ""
                if c == "#":
                    ev = commit(time)
                    if ev is not None:
                        yield ev
                    time = int(line[1:])
                elif c in "01xzXZ":
                    id_code = line[1:].strip()
                    if id_code in watch:
                        pending[id_code] = int(c) if c in "01" else None
                elif c in "bB":
                    val, id_code = line[1:].split()
                    if id_code in watch:
                        if any(ch in "xzXZ" for ch in val):
                            pending[id_code] = None
                        else:
                            pending[id_code] = int(val, 2)
                elif c in "rR":
                    pass  # real-valued tb bookkeeping, never tracked
                # $dumpvars / $end / $comment lines fall through harmlessly
            ev = commit(time)
            if ev is not None:
                yield ev


@dataclass
class Stream:
    """One handshaked input stream of a reference testbench."""

    data: str   # data signal name (relative to top scope)
    valid: str  # validity the TB drives (blocking, post-edge snapshot)
    ready: str  # readiness the DUT drives (pre-edge snapshot)


def extract_transactions(
    vcd_path: str,
    top: str,
    in_streams: Sequence[Stream],
    out_data: str,
    out_valid: str,
    out_ready: Optional[str],
    clk: str = "clk",
    rst_n: str = "rst_n",
    done: str = "done",
    out_cap: Optional[int] = None,
) -> List[Dict[str, List[int]]]:
    """Replay a reference tb dump into per-test I/O transactions.

    Returns one dict per completed test segment (delimited by rising
    ``done``), mapping each input stream's data name to the accepted
    sample list and ``out_data`` to the captured output list. Values are
    sign-extended ints.

    Input accept rule (tb_generator_mini.v:514-534 and the LOAD loops of
    tb_discriminator_mini.v): the tb blocking-assigns data/valid at the
    edge after observing ready high, so a sample is accepted when
    ``pre[ready] & post[valid]``; the accepted datum is ``post[data]``.
    Output capture rule (tb_generator_mini.v:544-550): the tb reads
    DUT-registered outputs in the active region, before that edge's
    non-blocking updates land — ``pre[valid_out] (& pre[ready_out])``
    captures ``pre[out_data]``.
    """
    vcd = VCD(vcd_path)

    def nm(leaf: str) -> str:
        return f"{top}.{leaf}"

    tracked = {"rst_n": nm(rst_n), "done": nm(done),
               "out_data": nm(out_data), "out_valid": nm(out_valid)}
    if out_ready is not None:
        tracked["out_ready"] = nm(out_ready)
    for i, s in enumerate(in_streams):
        tracked[f"in{i}_data"] = nm(s.data)
        tracked[f"in{i}_valid"] = nm(s.valid)
        tracked[f"in{i}_ready"] = nm(s.ready)

    widths = {k: vcd.width_of(n) for k, n in tracked.items()}

    tests: List[Dict[str, List[int]]] = []
    cur: Dict[str, List[int]] = {s.data: [] for s in in_streams}
    cur[out_data] = []
    prev_done = 0
    close_after_this_edge = False

    for _, pre, post in vcd.posedge_samples(nm(clk), tracked):
        if post.get("rst_n") != 1:
            continue
        for i, s in enumerate(in_streams):
            if pre.get(f"in{i}_ready") == 1 and post.get(f"in{i}_valid") == 1:
                v = post.get(f"in{i}_data")
                if v is not None:
                    cur[s.data].append(
                        to_signed(v, widths[f"in{i}_data"]))
        out_ok = pre.get("out_valid") == 1 and (
            out_ready is None or pre.get("out_ready") == 1)
        if out_ok and (out_cap is None or len(cur[out_data]) < out_cap):
            v = pre.get("out_data")
            if v is not None:
                cur[out_data].append(to_signed(v, widths["out_data"]))
        # The reference tbs observe ``done`` only when re-evaluating their
        # capture-loop condition AFTER the next posedge, so output words
        # registered on the done-rising edge are still captured one edge
        # later (tb_generator_mini.v:544-550). Close the segment after
        # processing that trailing edge, not on the rise itself.
        if close_after_this_edge:
            tests.append(cur)
            cur = {s.data: [] for s in in_streams}
            cur[out_data] = []
            close_after_this_edge = False
        d = post.get("done") or 0
        if d == 1 and prev_done == 0:
            close_after_this_edge = True
        prev_done = d

    if close_after_this_edge:
        # done rose on the final dumped edge; the trailing capture edge
        # never came — keep what we have.
        tests.append(cur)

    return tests
