"""The generator-gradient kernel's bound (``metrics/generator_grad_roofline.py``),
pinned, and its reader on a slice with and without the kernel."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import counts

PATH = Path(__file__).resolve().parents[1] / "metrics" / "generator_grad_roofline.py"


def metric():
    spec = importlib.util.spec_from_file_location("generator_grad_roofline", PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_macs_count_the_taps_inside_the_frame():
    m = metric()
    # taps inside: enc1 23, bottleneck 11, dec1 22, out_conv 46; the critic's 23 and 11
    gen = [23 * 2 * 4, 11 * 4 * 8, 22 * 8 * 4, 46 * 4 * 2]
    assert gen == [184, 352, 704, 368]
    critic = 23 * 4 * 8 + 11 * 8 * 16 + 16
    critic_back_to_fake = 23 * 2 * 8 + 11 * 8 * 16 + 16   # conv1 into fake's 2 channels only
    assert m.macs_per_frame() == 2 * sum(gen) + sum(gen[1:]) + critic + critic_back_to_fake \
        == 8592


@pytest.mark.parametrize("batch,bound_ms", [(65_536, 0.016809), (64, 1.6415e-5)])
def test_bound_is_bound_by_operations(batch, bound_ms):
    ms, by = metric().bound_ms(batch)
    assert by == "operations"
    assert ms == pytest.approx(bound_ms, rel=1e-4)
    assert ms == pytest.approx(batch * 2 * 8592 / counts.FP32_FLOPS_PER_S * 1e3)


def test_the_bytes_bound_reads_the_frames_and_parameters_once():
    m = metric()
    _, by = m.bound_ms(65_536, flops_per_s=1e18)
    assert by == "bytes"
    ms, _ = m.bound_ms(65_536, flops_per_s=1e18, bytes_per_s=1e12)
    assert ms == pytest.approx((65_536 * 256 + (258 + 521 + 258 + 3) * 4) / 1e12 * 1e3)


def _ctx(seconds_of, steps=64):
    trace = SimpleNamespace(steps=steps, seconds_of=seconds_of)
    return SimpleNamespace(trace=trace, cell={"batch": 65_536}, counts=counts)


def test_reader_shares_the_bound_over_the_device_time_a_step():
    m = metric()
    seen = []
    ctx = _ctx(lambda word: seen.append(word) or 64 * 0.12e-3)   # 0.12 ms a step
    assert m.read(ctx) == pytest.approx(100 * 0.016809 / 0.12, rel=1e-4)
    assert seen == ["generator_grad"]


def test_reader_reads_nothing_without_the_kernel():
    m = metric()
    assert m.read(_ctx(lambda word: 0.0)) is None
    assert m.read(SimpleNamespace(trace=None)) is None
