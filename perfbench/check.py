"""What decides ``correct``: the program's steps against the plain
reference's on the same weights, state and draws.

The checked steps are the program's first outer steps from the seed's
weights; the checked chunk is one call of the window's own chunk (a
graphed chunk's replay), which the reference follows from a copy of the
program's parameters and Adam state before it. Of each, four numbers; a
cell compares those its file gives a limit (a chunk's named
``chunk_<number>``):

* ``loss_gap``: over the steps (of a chunk, its last), the largest gap
  ``|p - r|`` of the last critic update's ``d_loss`` and of ``g_loss``,
  each over the reference's magnitude of the loss's terms (``|mean
  D(fake)| + |mean D(real)| + gp_weight GP``; ``adv_weight |adv| +
  rec_weight rec``): the Wasserstein difference crosses zero, so the loss
  itself is no scale;
* ``critic_grad_gap`` and ``gen_grad_gap``: the first gradient each
  optimizer takes (the critic's at the first critic update, before any
  Adam update has moved a weight; the generator's after the first step's
  critic updates; of a chunk, the last each takes), by the worst leaf: the
  gap between the program's norm of the leaf and the reference's, over the
  larger of the reference's norm of that leaf and of the net's median
  leaf;
* ``change_gap``: the same of each leaf's change over the steps.

A leaf whose reference gradient (the first, of a chunk the last) is under
a thousandth of its net's median leaf's (the critic's dense bias, whose
gradient cancels between the Wasserstein terms) moves under Adam by
round-off alone; it is left out of both leaf numbers by that rule, not by
its name.
"""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, List

import torch

from .reference import datagen as ref_datagen
from .reference.wgan_gp import Trainer

STEP_NUMBERS = ("loss_gap", "critic_grad_gap", "gen_grad_gap", "change_gap")
NUMBERS = STEP_NUMBERS + tuple(f"chunk_{k}" for k in STEP_NUMBERS)
NOUGHT = 1e-3   # a leaf under this share of the median leaf's gradient is left out


def reference_batch(draws: dict, config: dict, cell: dict, device: torch.device):
    """The reference's batch for one step's draws, on ``device``: the
    datagen kernel's stream worked out again from its seed, or the given
    normals."""
    B, L = cell["batch"], config["frame_length"]
    if "seed" in draws:
        normals = ref_datagen.normals_from_seed(draws["seed"], B, L, cell["datagen"]["nonlinear"],
                                                device)
    else:
        normals = {k: v.to(device) for k, v in draws["normals"].items()}
    out = ref_datagen.frames(normals, cell["datagen"])
    return {k: out[k].to(torch.float32) for k in ("noisy", "clean")}


@contextlib.contextmanager
def tf32_off():
    """Float32 with TF32 off while the block runs."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _norms(grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in grads.items()}


def _change(trainer: Trainer, start) -> Dict[str, Dict[str, float]]:
    with torch.no_grad():
        return {net: _norms({k: p - start[net][k] for k, p in ps.items()})
                for net, ps in (("generator", trainer.g), ("critic", trainer.d))}


def _follow(trainer: Trainer, config: dict, cell: dict, draws: List[dict],
            device: torch.device) -> List[dict]:
    return [trainer.step(reference_batch(d, config, cell, device),
                         [a.to(device) for a in d["alphas"]]) for d in draws]


def _losses(out: dict) -> dict:
    return {k: out[k] for k in ("d_loss", "d_scale", "g_loss", "g_scale")}


def reference_steps(config: dict, cell: dict, weights, draws: List[dict],
                    device: torch.device) -> dict:
    """The reference's readings of the checked steps: ``losses``, each
    net's first gradient ``grads`` and ``change``, as
    ``program.checked_steps`` gives the program's. Runs in float32 with
    TF32 off, on ``device``."""
    with tf32_off():
        trainer = Trainer(config, cell["recipe"], weights)
        outs = _follow(trainer, config, cell, draws, device)
        grads = {"generator": _norms(outs[0]["g_grads"]), "critic": _norms(outs[0]["d_grads"])}
        return {"losses": [_losses(o) for o in outs], "grads": grads,
                "change": _change(trainer, weights)}


def reference_chunk(config: dict, cell: dict, start: dict, draws: List[dict],
                    device: torch.device) -> dict:
    """The reference's readings of a checked chunk (``program.checked_chunk``)
    from the same start and draws: the last step's ``losses``, the last
    gradient each optimizer took ``grads``, and ``change``."""
    with tf32_off():
        trainer = Trainer(config, cell["recipe"], start["params"], adam=start["adam"])
        last = _follow(trainer, config, cell, draws, device)[-1]
        grads = {"generator": _norms(last["g_grads"]), "critic": _norms(last["d_last"])}
        return {"losses": [_losses(last)], "grads": grads,
                "change": _change(trainer, start["params"])}


def kept_leaves(ref_grads: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= NOUGHT * med]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> float:
    med = statistics.median(ref[k] for k in keep)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300) for k in keep]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def loss_gaps(prog: dict, ref: dict) -> List[Dict[str, float]]:
    """Each checked step's gaps of ``d_loss`` and ``g_loss``, each over the
    reference's magnitude of the loss's terms."""
    out = []
    for p, r in zip(prog["losses"], ref["losses"]):
        row = {}
        for key in ("d", "g"):
            if r[f"{key}_loss"] is not None:
                gap = abs(p[f"{key}_loss"] - r[f"{key}_loss"]) / max(r[f"{key}_scale"], 1e-300)
                row[key] = gap if math.isfinite(gap) else math.inf
        out.append(row)
    return out


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of the program's readings ``prog`` against the
    reference's ``ref``."""
    loss = max((g for row in loss_gaps(prog, ref) for g in row.values()), default=0.0)
    out = {"loss_gap": loss, "change_gap": 0.0}
    for net, key in (("critic", "critic_grad_gap"), ("generator", "gen_grad_gap")):
        if not ref["grads"][net]:   # a net the recipe never updates (n_critic 0)
            moved = any(prog["grads"][net].values()) or any(prog["change"][net].values())
            out[key] = math.inf if moved else 0.0
            continue
        keep = kept_leaves(ref["grads"][net])
        out[key] = leaf_gap(prog["grads"][net], ref["grads"][net], keep)
        out["change_gap"] = max(out["change_gap"],
                                leaf_gap(prog["change"][net], ref["change"][net], keep))
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def wants_chunk(cell: dict) -> bool:
    """Whether the cell compares a checked chunk's numbers."""
    return any(k.startswith("chunk_") for k in cell["limits"])


def chunk_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``numbers`` of a checked chunk, each named ``chunk_<number>``."""
    return {f"chunk_{k}": v for k, v in numbers(prog, ref).items()}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number the cell compares (the keys of its ``limits``) beside its
    limit; a number that is not finite fails."""
    return {k: {"value": values[k], "limit": limit, "ok": values[k] <= limit}
            for k, limit in limits.items()}
