"""The span metrics' readers (``metrics/device_ms_per_step.*``,
``host_ms_per_step.train``, ``build_s.setup``, ``capture_s.setup``) on
synthetic span records; nothing, and no span pass, where the port has no
spans; and the span pass of a traced run on the CPU, which has host times
and no device times."""

import importlib.util
import math

import pytest
import torch

from perfbench import counts, run, span_pass, spec
from perfbench.run import Context
from ofdmgan_tpu_torch.utils.spans import Record

READERS = ("device_ms_per_step.critic", "device_ms_per_step.generator",
           "device_ms_per_step.adam", "device_ms_per_step.datagen", "host_ms_per_step.train",
           "build_s.setup", "capture_s.setup")


def _ctx(cell="mini.gan.f32.b65536"):
    s = spec.cell(cell)
    return Context(s["config"], s["cell"], 20.0, {"steps": 1, "frames": 1, "seconds": 1.0},
                   1, None, 1, counts)


def _setup(name, i, ms):
    return Record(i, name, None, None, 10, 10 + int(ms * 1e6))


def test_each_reader_reads_its_span():
    ctx = _ctx()
    ctx._span_pass = {"device": {"step.critic": 2.4, "step.generator": 7.9, "optim": 0.32,
                                 "step.datagen": 0.04, "step": 0.03},
                      "host_ms_per_step": 0.5,
                      "setup": [_setup("ops.build", 0, 4500.0), _setup("ops.build", 1, 5500.0),
                                _setup("chunk.capture", 2, 760.0)]}
    got = {m: spec.reader(m)(ctx) for m in READERS}
    assert got == pytest.approx({"device_ms_per_step.critic": 2.4,
                                 "device_ms_per_step.generator": 7.9,
                                 "device_ms_per_step.adam": 0.32,
                                 "device_ms_per_step.datagen": 0.04,
                                 "host_ms_per_step.train": 0.5, "build_s.setup": 10.0,
                                 "capture_s.setup": 0.76})


def test_absent_spans_read_nothing_never_zero():
    ctx = _ctx()
    ctx._span_pass = {"device": {}, "host_ms_per_step": 0.0, "setup": []}
    assert all(spec.reader(m)(ctx) is None for m in READERS)


def test_a_port_without_spans_gives_nothing_and_runs_no_pass(monkeypatch):
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith(".spans") else find(name, *a))
    monkeypatch.setattr(span_pass, "_report", lambda *a: pytest.fail("a pass ran"))
    ctx = _ctx()
    assert all(spec.reader(m)(ctx) is None for m in READERS)
    assert ctx._span_pass is None


def test_every_span_metric_lists_the_cells_that_read_it():
    layers = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    both = {"mini.gan.f32.b65536", "full.gan.f32.b512"}
    for m in READERS:
        assert layers[m]["source"] == "program_span"
        assert set(layers[m]["workloads"]) == ({"mini.gan.f32.b65536"}
                                               if m == "capture_s.setup" else both)


def test_a_traced_run_on_the_cpu_reads_the_host_span_only():
    cell = "mini.gan.f32.b65536"
    line = run.run_cell(cell, 2 ** 31 + 15, 0.2, True, device=torch.device("cpu"),
                        overrides={"batch": 64, "chunk": {"kind": "eager", "steps": 2}})
    got = line["metrics"]
    assert math.isfinite(got["host_ms_per_step.train"]["value"])
    assert got["host_ms_per_step.train"]["value"] > 0
    assert not any(m.startswith("device_ms_per_step.") for m in got)
