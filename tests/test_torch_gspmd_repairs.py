"""Two repairs of the port's GSPMD step, held against the JAX package's.

``act_dtype``: the JAX trainer builds its GSPMD step without the setting
(``ofdmgan_tpu/training/trainer.py:323-330``), so its batch is never cast;
the mini pair stores its activations in its own modules and the full U-Net
has no storage at all. The port's trainer now passes no ``act_dtype`` to
its GSPMD step either: the mini pair with bf16 storage under ``{dp: 2}``
matches JAX's, and the full U-Net's update with the flag is the update
without it, bit for bit, and JAX's.

The activation scale: JAX's GSPMD step is one global program, so its
quantized U-Net's per-tensor activation scale is the maximum over the
global batch; the port's ranks each hold a shard and all-reduce their
maxima. Held point by point: every maximum the quantized generator takes
on a rank's shard under ``{dp: 2}`` equals the single-process maximum on
the global batch (rtol 1e-6: the same convolutions of the same frames) and
JAX's (rtol 1e-5: XLA's and ATen's sums round apart), and a planted variant
that keeps each rank's local maximum fails the first. The quantized step
is held against JAX's by its metrics (rtol 1e-4) and not by its update:
JAX's own step moves by 0.10 of a tensor's largest update between ``{dp:
1}`` and ``{dp: 2}`` (measured), because a float rounding that the layout
moves flips a 16-bit step of some activation, which Adam's per-entry
division carries into the update; the port's lies as far (0.10) and the
local maxima's five times farther (0.54).

Legs as ``tests/test_torch_parallel_gspmd.py`` (``jax_gspmd_legs.py``): L =
64, 3 levels, base 8 for the full family; three JAX steps warm the state,
then the port's two gloo ranks (one launch for the module) take one more
step through ``Trainer(strategy="gspmd")`` on JAX's global draws. Gate for
float32 steps: each tensor's update within 3e-4 of that update's largest
entry, the metrics rtol 1e-4 (the existing GSPMD legs' tolerance). The
bf16-storage step is held as ``tests/test_torch_act_dtype.py`` holds the
single-device one: every parameter within a tenth of an update (lr / 10)
and each tensor's update within 0.02 of the reference update's norm.

The pipeline (``strategy="pp"``) takes ``act_dtype`` and
``matmul_precision`` and, as the JAX trainer, passes neither on: its update
with them is its update without them, bit for bit.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from jax_gspmd_legs import (FULL, assert_bf16_step, assert_replicated, jax_leg, np_tree,
                            scale_distance, single_process_maxima, update_distances)
from ofdmgan_tpu.models.full_unet import FullUNetGenerator as JFullGen
from ofdmgan_tpu_torch.parallel import distributed
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from torch_parallel_ranks import trainer_legs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL = 3e-4
LAUNCH_TIMEOUT_S = 150
LEGS = {  # name: (JAX mesh, family, L, global batch, n_critic, act_dtype, generator modes)
    "mini_dp_bf16": ({"dp": 2}, "mini", 16, 64, 2, "bfloat16", {}),
    "full_dp": ({"dp": 2}, "full", 64, 8, 1, None, {}),
    "full_dp_quant": ({"dp": 2}, "full", 64, 8, 1, None, {"quant_bits": (8, 16)}),
}


@pytest.fixture(scope="module")
def runs():
    with ThreadPoolExecutor(len(LEGS)) as pool:
        done = {name: pool.submit(jax_leg, *args) for name, args in LEGS.items()}
        jax_side, legs = {}, {}
        for name, fut in done.items():
            legs[name], jax_side[name] = fut.result()
    legs["full_dp"]["also"] = {"full_dp_bf16_flag": {"act_dtype": "bfloat16"}}
    legs["full_dp_quant"]["scales"] = True
    legs["pp"] = {"pp": True, "frame_length": 64, "batch": 8, "pg": legs["full_dp"]["pg"]}
    ranks = distributed.launch(trainer_legs, 2, (legs,), threads=1, timeout_s=LAUNCH_TIMEOUT_S)
    return legs, jax_side, ranks


def _assert_matches_jax(jax_side, got, updates=True):
    _, _, jm = jax_side
    if updates:
        for k, rel in update_distances(jax_side, got).items():
            assert rel <= REL, (k, rel)
    for k, v in jm.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_mini_pair_with_bf16_storage_under_gspmd_matches_jax(runs):
    """R1: the batch is not cast; the modules store in bf16; the critic
    kernel, which has no storage format, is not routed."""
    _, jax_side, ranks = runs
    assert_replicated(ranks, "mini_dp_bf16")
    got = ranks[0]["mini_dp_bf16"]
    assert got["step_act_dtype"] is None and got["routes"] == ("kernel", "plain")
    _assert_matches_jax(jax_side["mini_dp_bf16"], got, updates=False)
    assert_bf16_step(jax_side["mini_dp_bf16"], got, runs[0]["mini_dp_bf16"]["lr"])


def test_full_unet_act_dtype_changes_nothing_under_gspmd(runs):
    """R1: the full U-Net's update with ``act_dtype="bfloat16"`` is the one
    without it, bit for bit, and both are JAX's."""
    _, jax_side, ranks = runs
    for r in ranks:
        with_flag, without = r["full_dp_bf16_flag"], r["full_dp"]
        assert with_flag["step_act_dtype"] is None
        for tag in ("params_g", "params_d"):
            for k in without[tag]:
                assert np.array_equal(with_flag[tag][k], without[tag][k]), k
        assert with_flag["metrics"] == without["metrics"]
    _assert_matches_jax(jax_side["full_dp"], ranks[0]["full_dp_bf16_flag"])


def test_quantized_full_unet_takes_the_global_activation_scale(runs):
    """R2: on each rank the quantized generator takes the global batch's
    maxima: the single-process ones, and JAX's global program's (the
    largest magnitude of each ``_maybe_quant_act`` output, which the
    quantization leaves in place); one MAX all-reduce of one value a point
    (a row-parallel weight's a vector). Its step's metrics are JAX's."""
    legs, jax_side, ranks = runs
    leg = legs["full_dp_quant"]
    want = single_process_maxima(leg)
    assert len([n for n, _ in want if not n.endswith(".weight")]) == 17
    for r in ranks:
        assert scale_distance(r["full_dp_quant_scales"], want) <= 1e-6
    jg = JFullGen(frame_length=64, weight_bits=8, act_bits=16, **FULL)
    _, state = jg.apply(leg["pg"], np.array(leg["draws"][0]["noisy"]), mutable=["intermediates"],
                        capture_intermediates=lambda _, name: name == "_maybe_quant_act")
    jmax = [float(np.abs(np.array(a)).max()) for a in state["intermediates"]["_maybe_quant_act"]]
    acts = [float(m[0]) for n, m in want if not n.endswith(".weight")]
    np.testing.assert_allclose(acts, jmax, rtol=1e-5)
    assert_replicated(ranks, "full_dp_quant")
    got = ranks[0]["full_dp_quant"]
    _assert_matches_jax(jax_side["full_dp_quant"], got, updates=False)
    assert got["traffic"]["calls"] > ranks[0]["full_dp"]["traffic"]["calls"]


def test_local_activation_scales_fail_the_gate(runs):
    """The scale check has power: each rank's local maxima differ from the
    global batch's on at least one rank."""
    legs, _, ranks = runs
    want = single_process_maxima(legs["full_dp_quant"])
    assert not all(scale_distance(r["quant_local_max_scales"], want) <= 1e-6 for r in ranks)


def test_pipeline_ignores_act_dtype_and_matmul_precision(runs):
    legs, _, ranks = runs
    for r in ranks:
        plain, flags = r["pp"]["plain"], r["pp"]["flags"]
        assert plain["rec_loss"] == flags["rec_loss"]
        for k in plain["params_g"]:
            assert np.array_equal(plain["params_g"][k], flags["params_g"][k]), k
        start = flatten_tree(np_tree(legs["pp"]["pg"]))
        assert any(not np.array_equal(plain["params_g"][k], v) for k, v in start.items())
