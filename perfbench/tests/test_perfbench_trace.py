"""The trace reader and the per-layer readers on a synthetic trace:
overlapping kernels count once in the busy time, a gap is named by the host
operation that spans it, operations outside the slice are left out, and a
roofline whose kernel is absent reads nothing, never 0."""

import json
from pathlib import Path

import pytest

from perfbench import counts, spec
from perfbench.run import Context
from perfbench.trace import SLICE, summarize

HERE = Path(__file__).resolve().parents[1]


def x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


# a slice from 1,000 to 2,000 us: kernels A [1000, 1300] and B [1200, 1500]
# overlap, a gap [1500, 1800] under aten::copy_, a copy [1800, 1900] and a
# gap [1900, 2000] under cudaDeviceSynchronize; one kernel before the slice
EVENTS = [
    x(SLICE, "user_annotation", 1000, 1000),
    x("datagen_kernel<16>", "kernel", 500, 100),
    x("void critic_grad_kernel<false, 0>", "kernel", 1000, 300),
    x("sm90_xmma_wgrad", "kernel", 1200, 300),
    x("Memcpy DtoD", "gpu_memcpy", 1800, 100),
    x("aten::copy_", "cpu_op", 1400, 500),
    x("aten::to", "cpu_op", 1300, 700),
    x("cudaDeviceSynchronize", "cuda_runtime", 1890, 110),
]


def test_union_busy_time_kernels_and_gaps():
    s = summarize(EVENTS, steps=2)
    assert s.span_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(600e-6)     # [1000, 1500] and [1800, 1900]
    assert s.device_s == pytest.approx(700e-6)   # 300 + 300 + 100
    assert s.kernels == 2
    assert s.gaps == [("aten::copy_", pytest.approx(300e-6)),
                      ("cudaDeviceSynchronize", pytest.approx(100e-6))]
    assert s.seconds_of("datagen_kernel") == 0.0


def test_no_slice_annotation_reads_nothing():
    assert summarize([e for e in EVENTS if e["name"] != SLICE], steps=2) is None


def context(summary, cell_name):
    s = spec.cell(cell_name)
    return Context(s["config"], s["cell"], 1.0, {"steps": 64, "frames": 64 * s["cell"]["batch"],
                                                 "seconds": 1.0}, 1 << 30, summary)


def read(metric, ctx):
    return spec.reader(metric)(ctx)


def test_readers_on_the_synthetic_slice():
    ctx = context(summarize(EVENTS, steps=2), "mini.gan.f32.b65536")
    assert read("idle_share.train", ctx) == pytest.approx(40.0)
    assert read("device_ms_per_step.train", ctx) == pytest.approx(0.35)
    assert read("kernels_per_step.train", ctx) == pytest.approx(1.0)
    bound, _ = counts.critic_bound_ms(65_536)
    assert read("critic_grad_roofline", ctx) == pytest.approx(100 * bound / (0.3 / 10))


def test_an_absent_kernel_reads_nothing_never_zero():
    ctx = context(summarize(EVENTS, steps=2), "mini.gan.f32.b65536")
    assert read("datagen_roofline", ctx) is None
    no_critic = [e for e in EVENTS if "critic_grad" not in e["name"]]
    assert read("critic_grad_roofline", context(summarize(no_critic, 2),
                                                "mini.gan.f32.b65536")) is None


@pytest.mark.parametrize("metric", ["idle_share.train", "device_ms_per_step.train",
                                    "kernels_per_step.train", "critic_grad_roofline",
                                    "datagen_roofline"])
def test_device_metrics_read_nothing_without_a_trace(metric):
    assert read(metric, context(None, "mini.gan.f32.b65536")) is None


def test_mfu_reads_the_window():
    ctx = context(None, "full.gan.f32.b512")
    want = 100 * counts.step_flops(ctx.config, 512, 5) * 64 / 1.0 / 67e12
    assert read("mfu.train", ctx) == pytest.approx(want)


def test_every_metric_has_a_reader():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
