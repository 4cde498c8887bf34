"""The operation and byte counts of the step and of its kernels, pinned."""

import json
from pathlib import Path

import pytest

from perfbench import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_full_gan_step_flops_at_512():
    assert counts.step_flops(config("full_unet"), 512, 5) == 3_149_183_057_920


def test_mini_step_flops_at_65536():
    assert counts.step_flops(config("mini_pair"), 65_536, 5) == 20_665_335_808


def test_macs_per_frame_are_8g_plus_62d_at_n_critic_5():
    g, d = counts.macs_per_frame(config("mini_pair"))
    assert (g, d) == (1_728, 2_320)
    assert counts.step_flops(config("mini_pair"), 1, 5) == 2 * (8 * g + 62 * d)


@pytest.mark.parametrize("batch,bound_ms", [(65_536, 0.0391), (64, 3.81e-5)])
def test_critic_bound_is_bound_by_operations(batch, bound_ms):
    ms, by = counts.critic_bound_ms(batch)
    assert by == "operations"
    assert ms == pytest.approx(bound_ms, rel=2e-3)


def test_the_supervised_step_counts_the_generator_alone():
    g, _ = counts.macs_per_frame(config("full_unet"))
    assert counts.step_flops(config("full_unet"), 512, 0) == 2 * 512 * 3 * g


def test_critic_macs_count_the_taps_inside_the_frame():
    # 23 taps of conv1 (8 outputs x 3, one left of the frame) x 32, 11 of conv2 x 128
    assert counts.critic_macs_per_frame() == 8 * 23 * 32 + 10 * 11 * 128


def test_datagen_bound_at_a_million_frames_of_16():
    ms, by = counts.datagen_bound_ms(1 << 20, 16)
    assert by == "bytes"
    assert ms == pytest.approx(0.0814, rel=2e-3)


def test_datagen_bound_of_the_full_step_is_bytes():
    ms, by = counts.datagen_bound_ms(512, 1024)
    assert by == "bytes"
    assert ms == pytest.approx(512 * 4097 * 4 / 3.35e12 * 1e3)
