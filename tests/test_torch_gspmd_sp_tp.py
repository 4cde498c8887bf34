"""The port's GSPMD step on the layouts it refused before, against the JAX
package's: ``sp`` with the mini pair (the default, the RTL-residual QAT
recipe and bf16 module storage), and ``tp`` and ``sp`` with the quantized
full U-Net (``--quant_bits 8 16``) and with the fused decoder.

Legs as ``tests/test_torch_gspmd_repairs.py`` (``jax_gspmd_legs.py``; L =
16 for the mini pair at a global batch of 64 and n_critic 2; L = 64, 3
levels, base 8, batch 8 and n_critic 1 for the full family): three JAX
steps warm the state, the port's two gloo ranks (one launch for the
module) take one more through ``Trainer(strategy="gspmd")`` on JAX's global
draws. Gates: float32 and QAT steps, each tensor's update within 3e-4 of
its largest entry and the metrics rtol 1e-4 (the existing GSPMD legs'; the
QAT operands lie on the 2^-8 and 2^-7 grids, so its sums are exact and
round nowhere apart); the bf16-storage step as the single-device one,
every parameter within lr / 10 and each update within 0.02 of the
reference update's norm; the quantized steps by their metrics and by every
quantization point's maximum on each rank's shard against the single-process
maxima on the global batch (rtol 1e-6 under ``sp``, whose convolutions sum
the same samples in the same order; under ``tp`` within one 16-bit step,
2^-15 of the maximum, since the row-parallel layers' partial sums, added
over ``tp``, round apart from one sum and move the values after them by
float rounding and an occasional step; measured 1.9e-5), as ``test_torch_gspmd_repairs.py``
says why.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from jax_gspmd_legs import (assert_bf16_step, assert_replicated, jax_leg, scale_distance,
                            single_process_maxima, update_distances)
from ofdmgan_tpu_torch.parallel import distributed
from torch_parallel_ranks import trainer_legs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL = 3e-4
SCALE_RTOL = {"full_sp_quant": 1e-6,      # the same convolutions of the same samples
              "full_tp_quant": 2.0 ** -15}  # one 16-bit step: the row-parallel sums round apart
LAUNCH_TIMEOUT_S = 150
TP, SP = {"dp": 1, "tp": 2}, {"dp": 1, "sp": 2}
RTL_QAT = {"qat": True, "rtl_faithful": True, "input_residual": True}
QUANT = {"quant_bits": (8, 16)}
LEGS = {  # name: (JAX mesh, family, L, global batch, n_critic, act_dtype, modes[, fused])
    "mini_sp": (SP, "mini", 16, 64, 2, None, {}),
    "mini_sp_rtl_qat": (SP, "mini", 16, 64, 2, None, RTL_QAT),
    "mini_sp_bf16": (SP, "mini", 16, 64, 2, "bfloat16", {}),
    "full_tp_quant": (TP, "full", 64, 8, 1, None, QUANT),
    "full_sp_quant": (SP, "full", 64, 8, 1, None, QUANT),
    "full_tp_fused": (TP, "full", 64, 8, 1, None, {}, True),
    "full_sp_fused": (SP, "full", 64, 8, 1, None, {}, True),
}
FLOAT_LEGS = ("mini_sp", "mini_sp_rtl_qat", "full_tp_fused", "full_sp_fused")
QUANT_LEGS = ("full_tp_quant", "full_sp_quant")


@pytest.fixture(scope="module")
def runs():
    with ThreadPoolExecutor(4) as pool:
        done = {name: pool.submit(jax_leg, *args) for name, args in LEGS.items()}
        jax_side, legs = {}, {}
        for name, fut in done.items():
            legs[name], jax_side[name] = fut.result()
    for name in QUANT_LEGS:
        legs[name]["scales"] = True
    ranks = distributed.launch(trainer_legs, 2, (legs,), threads=1, timeout_s=LAUNCH_TIMEOUT_S)
    return legs, jax_side, ranks


def _metrics(jax_side, got):
    for k, v in jax_side[2].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", FLOAT_LEGS)
def test_float_and_qat_legs_match_jax(runs, name):
    legs, jax_side, ranks = runs
    assert_replicated(ranks, name)
    got = ranks[0][name]
    for k, rel in update_distances(jax_side[name], got).items():
        assert rel <= REL, (k, rel)
    _metrics(jax_side[name], got)
    if legs[name]["mesh"].get("sp", 1) > 1:   # the critic kernel needs whole frames
        assert got["routes"][1] == "plain"
    if name == "mini_sp":
        assert got["routes"][0] == "kernel"


def test_mini_sp_with_bf16_storage_matches_jax(runs):
    legs, jax_side, ranks = runs
    assert_replicated(ranks, "mini_sp_bf16")
    got = ranks[0]["mini_sp_bf16"]
    assert got["step_act_dtype"] is None
    _metrics(jax_side["mini_sp_bf16"], got)
    assert_bf16_step(jax_side["mini_sp_bf16"], got, legs["mini_sp_bf16"]["lr"])


@pytest.mark.parametrize("name", QUANT_LEGS)
def test_quantized_legs_take_the_global_scales(runs, name):
    """Every point's maximum on each rank's shard is the global batch's
    (under ``tp`` a column-parallel kernel's are its rank's output
    channels'); the step's metrics are JAX's."""
    legs, jax_side, ranks = runs
    want = single_process_maxima(legs[name])
    for rank, r in enumerate(ranks):
        assert scale_distance(r[f"{name}_scales"], want, rank, 2) <= SCALE_RTOL[name]
    assert_replicated(ranks, name)
    _metrics(jax_side[name], ranks[0][name])


def test_tensor_parallel_legs_train_shards(runs):
    """Under tp each rank trained shards of the sharded kernels, the fused
    decoder's ``dec*_1`` among them, and moved bytes through collectives."""
    _, _, ranks = runs
    for name in ("full_tp_quant", "full_tp_fused"):
        assert ranks[0][name]["traffic"]["collective_bytes"] > 0
