"""The port's spans (``ofdmgan_tpu_torch/utils/spans.py``): off, a span is
the shared no-op context and nothing is recorded, in the records or in a
profiler's trace; on, one outer step of the mini pair records its phases
with their parents and one step id, on both critic routes; the set-up spans
(a library's build, a graph's capture) are host-only and kept with spans
off; the self-time reduction; the trainer's ``spans.json``. On the card
(``cuda``), the phases' device times of an eager step and of a graphed
chunk cover the step's span within 3 %.

The file imports no JAX, so its card test also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -m cuda -q
"""

import contextlib
import json
import time
from pathlib import Path

import pytest
import torch

from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.ops import build
from ofdmgan_tpu_torch.signal import datagen as sdg
from ofdmgan_tpu_torch.training import chunks
from ofdmgan_tpu_torch.training.schedules import make_adam
from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep
from ofdmgan_tpu_torch.utils import spans

PHASES = ("step.datagen", "step.critic", "step.generator", "optim")


@pytest.fixture(autouse=True)
def clean_spans():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _mini_step(device="cpu", batch=16, reference=False):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g, d = MiniGenerator().to(device), MiniDiscriminator().to(device)
    return TrainStep(g, d, make_adam(g.parameters(), 2e-4, (0.0, 0.9)),
                     make_adam(d.parameters(), 2e-4, (0.0, 0.9)), sdg.DatagenConfig(),
                     LossConfig(), batch, reference=reference)


def test_off_a_span_is_the_shared_null_context_and_nothing_is_recorded():
    from torch.profiler import ProfilerActivity, profile

    assert spans.span("step.critic") is spans.NULL
    assert spans.host_span("chunk") is spans.NULL
    assert spans.step() is spans.NULL
    step = _mini_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(torch.Generator().manual_seed(1))
    assert spans.records() == []
    names = {e.key for e in prof.key_averages()}
    assert not names & {spans.STEP, *PHASES}


@pytest.mark.parametrize("reference", [False, True], ids=["kernel_route", "plain_route"])
def test_on_one_mini_step_records_its_phases_under_one_step(reference):
    from torch.profiler import ProfilerActivity, profile

    step = _mini_step(reference=reference)
    assert step.critic_route == ("plain" if reference else "kernel")
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(torch.Generator().manual_seed(1))
    recs = spans.records()
    count = {n: sum(r.name == n for r in recs) for n in (spans.STEP, *PHASES)}
    n = step.loss_cfg.n_critic
    assert count == {"step": 1, "step.datagen": 1, "step.critic": n, "step.generator": 1,
                     "optim": n + 1}
    assert len(recs) == sum(count.values())
    (top,) = [r for r in recs if r.name == spans.STEP]
    by_id = {r.id: r for r in recs}
    assert top.parent is None and {r.step for r in recs} == {top.id}
    for r in recs:
        if r.name in ("step.datagen", "step.critic", "step.generator"):
            assert r.parent == top.id
        elif r.name == "optim":
            assert by_id[r.parent].name in ("step.critic", "step.generator")
        assert r.events is None and r.host_end_ns >= r.host_start_ns
    assert {spans.STEP, *PHASES} <= {e.key for e in prof.key_averages()}


def test_run_from_draws_opens_its_own_step():
    step = _mini_step()
    draws = step.draw(torch.Generator().manual_seed(2))
    spans.enable()
    step.run(*draws)
    recs = spans.records()
    assert [r.name for r in recs if r.parent is None] == [spans.STEP]
    assert sum(r.name == "step.critic" for r in recs) == step.loss_cfg.n_critic
    assert not any(r.name == "step.datagen" for r in recs)


def test_setup_spans_are_host_only_and_kept_with_spans_off(monkeypatch):
    monkeypatch.setattr(build, "build", lambda names: {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    build.load.__wrapped__("datagen")   # past the cache, so the test builds nothing

    class Graph:
        def register_generator_state(self, rng):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    chunk = chunks.GraphedChunk.__new__(chunks.GraphedChunk)
    chunk.rng, chunk.eager = torch.Generator(), lambda: {"d_loss": torch.zeros(())}
    chunk.capture()
    assert spans.span("x") is spans.NULL
    recs = spans.records()
    assert [r.name for r in recs] == ["ops.build", "chunk.capture"]
    assert all(r.events is None and r.step is None and r.host_ms >= 0 for r in recs)
    assert spans.per_step_ms(recs, device=False) == {}


def test_self_time_an_outer_step():
    def rec(i, name, parent, step, ms):
        return spans.Record(i, name, parent, step, 0, int(ms * 1e6))

    recs = [rec(0, "chunk", None, None, 30.0), rec(1, "step", 0, 1, 12.0),
            rec(2, "step.critic", 1, 1, 5.0), rec(3, "optim", 2, 1, 1.0),
            rec(4, "step.generator", 1, 1, 6.0), rec(5, "optim", 4, 1, 2.0),
            rec(6, "step", 0, 6, 14.0), rec(7, "step.critic", 6, 6, 7.0),
            rec(8, "step.generator", 6, 6, 6.5)]
    ms = spans.per_step_ms(recs, device=False)
    assert ms == pytest.approx({"chunk": 2.0, "step": 0.75, "step.critic": 5.5, "optim": 1.5,
                                "step.generator": 5.25})
    assert sum(ms.values()) == pytest.approx(30.0 / 2)
    assert spans.per_step_ms(recs) == {}   # no span has device events


def test_profile_writes_spans_beside_the_trace(tmp_path):
    from ofdmgan_tpu_torch.config import Config, TrainingSection
    from ofdmgan_tpu_torch.training.trainer import Trainer

    cfg = Config(training=TrainingSection(batch_size=16), checkpoint_dir=str(tmp_path / "ck"),
                 log_dir=str(tmp_path / "logs"), export_dir=str(tmp_path / "export"))
    t = Trainer(cfg, samples_per_epoch=32, val_samples=16, device="cpu", seed=0)
    out = Path(t.profile_steps(1, str(tmp_path / "prof")))
    assert spans.span("x") is spans.NULL   # off again
    data = json.loads((out / "spans.json").read_text())
    assert data["steps"] == t.scan_steps
    assert {spans.STEP, *PHASES, "chunk"} <= set(data["host_ms_per_step"])
    assert all(v >= 0 for v in data["host_ms_per_step"].values())
    assert "device_ms_per_step" not in data   # a CPU run has no device times
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    assert {"step.critic", "step.generator"} <= {e.get("name") for e in events}


@pytest.mark.cuda
def test_phases_cover_the_step_on_the_card():
    """An eager step and a graphed 4-step chunk at 16 times the mini cell's
    batch, spans on: each phase reads a positive device time; the phases'
    self times plus the step's own lie within 3 % of the step spans' device
    time, and the phases alone cover 97 % of it; the host's clock around
    the synchronized call bounds it. A span's device time runs from event
    to event, so where the host enqueues an eager step more slowly than
    the device runs it, the device's waits for the host between two phases
    read as the step's own time: at 2^20 frames the eager step is device
    bound (on an H100 some 40 ms of device work against ~13 ms of host
    enqueue), so that the step's own time holds only device
    work outside the phases."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", torch.cuda.current_device())
    step = _mini_step(dev, batch=1 << 20)
    step.opt_g.hold_on_device()
    step.opt_d.hold_on_device()
    rng = torch.Generator(device=dev).manual_seed(3)
    eager = chunks.EagerChunk(step, rng, 1)
    graphed = chunks.GraphedChunk(step, rng, 4)
    eager()
    spans.enable()
    graphed()   # the warm-up chunk
    torch.cuda.synchronize(dev)
    for name, run, k in (("eager", eager, 1), ("graphed", graphed, 4)):
        first = len(spans.records())
        if name == "graphed":
            graphed()   # the capture, then a replay
            torch.cuda.synchronize(dev)
            recs = [r for r in spans.records()[first:] if r.step is not None]
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        if name == "eager":
            recs = spans.records()[first:]
        ms = spans.per_step_ms(recs)
        total = sum(r.device_ms for r in recs if r.name == spans.STEP) / k
        assert all(ms[p] > 0 for p in PHASES), (name, ms)
        phases = sum(ms[p] for p in PHASES)
        assert abs(phases + ms[spans.STEP] - total) <= 0.03 * total, name
        assert phases >= 0.97 * total, (name, ms, total)
        assert total * k <= wall_ms, (name, total, wall_ms)
