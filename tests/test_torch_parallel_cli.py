"""The port's multi-rank trainer through its CLI, and its multi-rank dry run.

``python -m ofdmgan_tpu_torch.train --device cpu --dp 2 --local_devices 2``
spawns two gloo ranks. They resume from a checkpoint of a one-process run
(three steps, so Adam's state is warm: from a fresh state a gradient that
is zero up to rounding becomes a full step of either sign) and take three
more steps. The ranks end in lockstep (equal parameters), and match a
one-process run of the same three steps on the two replicas' concatenated
draws (each replica's frames from ``replica_generator(seed, i)``, the seeds
from the trainer's ``step_seeds``) within rtol 1e-5 on the parameters'
checksum and the logged metrics, as ``tests/test_distributed.py:55-80``
holds its two processes to one. Rank 0 alone writes the checkpoint and the
metrics. ``dryrun_multichip(4)`` runs every leg of the dry run on four
ranks.
"""

import json

import numpy as np
import pytest
import torch

from ofdmgan_tpu_torch import dryrun
from ofdmgan_tpu_torch import train as train_cli
from ofdmgan_tpu_torch.config import Config
from ofdmgan_tpu_torch.parallel.mesh import draw_seed, replica_generator
from ofdmgan_tpu_torch.training.trainer import TRAIN_LOG_KEYS, Trainer
from ofdmgan_tpu_torch.training.wgan_gp import TrainStep
from ofdmgan_tpu_torch.utils.jax_params import to_jax_params
from ofdmgan_tpu_torch.utils.params_io import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, STEPS = 32, 3


def _flags(tmp, name):
    return ["--device", "cpu", "--batch_size", str(B), "--samples_per_epoch", str(STEPS * B),
            "--val_samples", str(B), "--skip_export", "--checkpoint_dir", f"{tmp}/{name}/ck",
            "--log_dir", f"{tmp}/{name}/logs", "--experiment", "run"]


def _checksum(params: dict) -> float:
    return float(sum(np.asarray(v, np.float64).sum() for v in params.values()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_cli")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")   # the spawned ranks' torch threads
        warm = train_cli.main(_flags(tmp, "warm") + ["--epochs", "1"])
        resume = str(tmp / "warm" / "ck" / "final_model")
        ranks = train_cli.main(_flags(tmp, "dp2") + ["--epochs", "1", "--dp", "2",
                                                     "--local_devices", "2",
                                                     "--resume", resume])
    # one process, the same three steps on both replicas' draws concatenated
    ref = Trainer(Config(export_after_training=False,
                         training=warm.config.training), samples_per_epoch=STEPS * B,
                  val_samples=B, device="cpu")
    ref.load_checkpoint(resume)
    half = TrainStep(ref.generator, ref.critic, ref.opt_g, ref.opt_d, ref.dg_cfg, ref.loss_cfg,
                     B // 2)
    seeds = torch.Generator().manual_seed(1)   # the trainer's step_seeds (seed 0 + 1)
    for _ in range(STEPS):
        seed = draw_seed(seeds)
        parts = [half.draw(replica_generator(seed, i, torch.device("cpu"))) for i in range(2)]
        batch = {k: torch.cat([p[0][k] for p in parts]) for k in parts[0][0]}
        alphas = [torch.cat([p[1][j] for p in parts]) for j in range(len(parts[0][1]))]
        metrics = ref.step.run(batch, alphas)
    return {"tmp": tmp, "ranks": ranks, "ref": ref,
            "ref_metrics": {k: float(v) for k, v in metrics.items()}}


def test_two_ranks_stay_in_lockstep(runs):
    r0, r1 = runs["ranks"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    for tag in ("params_g", "params_d"):
        for k in r0[tag]:
            assert np.array_equal(r0[tag][k], r1[tag][k]), (tag, k)
    assert r0["history"] == r1["history"] and len(r0["history"]) == 1


def test_two_ranks_match_one_process_on_the_concatenated_draws(runs):
    r0, ref = runs["ranks"][0], runs["ref"]
    want = {**flatten_tree(to_jax_params(ref.generator)), **flatten_tree(to_jax_params(ref.critic))}
    got = {**r0["params_g"], **r0["params_d"]}
    np.testing.assert_allclose(_checksum(got), _checksum(want), rtol=1e-5)
    logged = r0["history"][0]
    for key, metric in TRAIN_LOG_KEYS.items():
        np.testing.assert_allclose(logged[f"train/{key}"], runs["ref_metrics"][metric],
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_only_rank_zero_writes(runs):
    r0, r1 = runs["ranks"]
    assert (r0["is_main_process"], r1["is_main_process"]) == (True, False)
    run = runs["tmp"] / "dp2"
    lines = (run / "logs" / "run" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])["step"] == 2 * STEPS   # train and val, once
    assert (run / "ck" / "final_model" / "params_g.npz").exists()
    sidecar = json.loads((run / "ck" / "final_model" / "trainer_state.json").read_text())
    assert sidecar["global_step"] == 2 * STEPS


def test_the_flags_default_as_the_reference():
    args = train_cli.build_parser().parse_args([])
    assert (args.dp, args.strategy, args.tp, args.sp, args.pp, args.microbatches) == \
        (None, "shard_map", 1, 1, 0, 8)
    assert (args.coordinator, args.num_processes, args.process_id, args.local_devices) == \
        (None, None, None, None)


def test_dryrun_multichip_on_four_ranks():
    out = dryrun.dryrun_multichip(4)
    assert out["dp"]["mesh"] == {"dp": 2, "tp": 2}
    assert [leg["mesh"] for leg in out["gspmd"]] == [{"dp": 4}, {"dp": 2, "tp": 2},
                                                    {"dp": 2, "sp": 2}]
    assert out["pp"]["max_param_delta"] < 1e-6
    assert out["lockstep_rel"] < 1e-6
