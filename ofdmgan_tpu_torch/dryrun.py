"""Driver entry points of the port: a forward step to run, and the multi-rank
dry run: ``python -m ofdmgan_tpu_torch.dryrun [N]`` (N ranks, default 8).

Counterpart of the repository's ``__graft_entry__.py``. ``entry()`` returns
the mini generator's forward and its example arguments on the GPU (or on
``device``). ``dryrun_multichip(n)`` runs the reference's legs on ``n``
gloo ranks on this host's CPU (the port's counterpart of ``n`` virtual CPU
devices, ``parallel/distributed.py``), each one step at small shapes, and
raises on any failed check:

* **dp**: the mini pair's data-parallel step (nonlinear datagen, n_critic
  2, four frames a replica) over ``{dp: n/2, tp: 2}`` where ``n`` allows a
  second axis, else ``{dp: n}``; finite metrics, every rank's parameters
  equal;
* **gspmd**: the full U-Net pair (L = 64, 3 levels, base 8, n_critic 1,
  global batch 2n) from one state, warmed up by two single-process steps,
  on ``{dp: n}``, ``{dp: n/2, tp: 2}`` and ``{dp: n/2, sp: 2}``; the
  parameters' checksums agree within relative 1e-5 (one global function,
  only the collectives differ);
* **pp**: the two-stage GPipe pipeline (4 microbatches, SGD 1e-2, batch 8)
  against the single-device supervised update: the largest parameter
  difference under 1e-6 and the loss within 1e-5;
* **lockstep**: the data-parallel trainer as two launches of ``n/2`` ranks
  joined at one ``file://`` store and as one launch of ``n`` ranks, over
  the same global mesh: their checkpoints' checksums within relative 1e-6.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .parallel import distributed

GSPMD_REL = 1e-5     # layout equivalence of the full U-Net's checksums
PP_ATOL = 1e-6       # pipelined against single-device SGD update
LOCKSTEP_REL = 1e-6  # two launches against one


def entry(device=None):
    """``(fn, args)``: the ``MiniGenerator`` forward on a batch of 64 noisy
    frames, on ``device`` (default: the GPU)."""
    from .device import resolve_device
    from .models import MiniGenerator

    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = MiniGenerator().to(dev)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 16, 2)).astype(np.float32))

    def fn(model, noisy):
        return model(noisy)

    return fn, (model, x.to(dev))


def _checksum(*modules) -> float:
    return float(sum(p.detach().double().sum() for m in modules for p in m.parameters()))


def _full_pair(warm_steps: int = 0):
    """The small full U-Net pair from seed 0 with Adam 1e-4, after
    ``warm_steps`` single-process steps (from a fresh Adam state, an update
    turns a gradient that is zero up to rounding into a full step of either
    sign, so layouts are compared from a warmed-up state)."""
    from .models.full_unet import FullDiscriminator, FullUNetGenerator
    from .signal.datagen import DatagenConfig
    from .training.schedules import make_adam
    from .training.wgan_gp import LossConfig, TrainStep

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g = FullUNetGenerator(frame_length=64, levels=3, base_channels=8)
        d = FullDiscriminator(frame_length=64, levels=3, base_channels=8)
    opt_g, opt_d = make_adam(g.parameters(), 1e-4), make_adam(d.parameters(), 1e-4)
    step = TrainStep(g, d, opt_g, opt_d, DatagenConfig(frame_length=64), LossConfig(n_critic=1), 8)
    rng = torch.Generator().manual_seed(4)
    for _ in range(warm_steps):
        step(rng)
    return g, d, opt_g, opt_d


def _legs(n: int) -> dict:
    """Every leg but the lockstep, on this rank of ``n``."""
    from .models import MiniDiscriminator, MiniGenerator
    from .models.full_unet import unet_param_shardings
    from .parallel import (make_gspmd_train_step, make_mesh, make_pp_supervised_train_step,
                           make_sharded_train_step)
    from .parallel.mesh import axis_size
    from .signal.datagen import DatagenConfig, synthetic_batch
    from .training.schedules import make_adam
    from .training.wgan_gp import LossConfig

    out = {}
    mesh = make_mesh({"dp": n // 2, "tp": 2} if n % 2 == 0 and n > 2 else {"dp": n})
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g, d = MiniGenerator(), MiniDiscriminator()
    step = make_sharded_train_step(
        g, d, make_adam(g.parameters(), 1e-4), make_adam(d.parameters(), 1e-4),
        DatagenConfig(frame_length=16, nonlinear=True), LossConfig(n_critic=2),
        4 * axis_size(mesh, "dp"), mesh)
    m = step(torch.Generator().manual_seed(1))
    out["dp"] = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                 "metrics": {k: float(v) for k, v in m.items()}, "checksum": _checksum(g, d),
                 "routes": (step.datagen_route, step.critic_route)}

    layouts = [{"dp": n}]
    if n % 2 == 0 and n > 2:
        layouts += [{"dp": n // 2, "tp": 2}, {"dp": n // 2, "sp": 2}]
    out["gspmd"] = []
    for layout in layouts:
        fg, fd, opt_g, opt_d = _full_pair(warm_steps=2)
        gstep = make_gspmd_train_step(fg, fd, opt_g, opt_d, DatagenConfig(frame_length=64),
                                      LossConfig(n_critic=1), 2 * n, make_mesh(layout),
                                      gen_tp_rule=unet_param_shardings)
        gm = gstep(torch.Generator().manual_seed(2))
        gstep.gather_into(fg, opt_g)
        out["gspmd"].append({"mesh": layout, "g_loss": float(gm["g_loss"]),
                             "checksum": _checksum(fg, fd)})

    if n >= 2:
        cfg = DatagenConfig(frame_length=64, nonlinear=True)
        fg, ref = _full_pair()[0], _full_pair()[0]
        pp = make_pp_supervised_train_step(
            fg, torch.optim.SGD(fg.parameters(), 1e-2), cfg, 8, 4,
            make_mesh({"dp": n // 2, "pp": 2} if n > 2 else {"pp": 2}))
        pm = pp(torch.Generator().manual_seed(3))
        batch = synthetic_batch(torch.Generator().manual_seed(3), 8, cfg)
        loss = (ref(batch["noisy"]) - batch["clean"]).abs().mean()
        loss.backward()
        torch.optim.SGD(ref.parameters(), 1e-2).step()
        delta = max(float((a - b).detach().abs().max())
                    for a, b in zip(fg.parameters(), ref.parameters()))
        out["pp"] = {"max_param_delta": delta, "rec_loss": float(pm["rec_loss"]),
                     "ref_loss": float(loss)}
    return out


def _lockstep(n: int, workdir: str) -> float:
    """Two launches of ``n/2`` ranks against one of ``n``: the relative
    difference of their trained checkpoints' checksums."""
    from .utils.params_io import load_params_tree, flatten_tree

    common = [sys.executable, "-m", "ofdmgan_tpu_torch.train", "--device", "cpu",
              "--epochs", "1", "--batch_size", str(4 * n), "--samples_per_epoch", str(8 * n),
              "--val_samples", str(4 * n), "--n_critic", "2", "--skip_export"]
    repo = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "OMP_NUM_THREADS": "1"}

    def args(name, *extra):
        return common + ["--checkpoint_dir", f"{workdir}/{name}/ck",
                         "--log_dir", f"{workdir}/{name}/logs", *extra]

    store = f"file://{workdir}/store"
    procs = [subprocess.Popen(args("two", "--coordinator", store, "--num_processes", "2",
                                   "--process_id", str(i), "--local_devices", str(n // 2)),
                              cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    one = subprocess.run(args("one", "--local_devices", str(n)), cwd=repo, env=env,
                         capture_output=True, text=True, timeout=600)
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for rc, text in [(one.returncode, one.stdout + one.stderr)] + [(p.returncode, o)
                                                                   for p, o in zip(procs, outs)]:
        if rc != 0:
            raise RuntimeError(f"a lockstep launch failed:\n{text[-3000:]}")

    def checksum(name):
        total = 0.0
        for f in ("params_g.npz", "params_d.npz"):
            tree = load_params_tree(f"{workdir}/{name}/ck/final_model/{f}")
            total += float(sum(np.asarray(v, np.float64).sum()
                               for v in flatten_tree(tree).values()))
        return total

    a, b = checksum("two"), checksum("one")
    return abs(a - b) / max(1e-12, abs(b))


def dryrun_multichip(n_devices: int) -> dict:
    """Run every leg on ``n_devices`` gloo CPU ranks; raises on a failed
    check and returns the legs' results."""
    results = distributed.launch(_legs, n_devices, (n_devices,), threads=1, timeout_s=600)
    r0 = results[0]
    sums = {r["dp"]["checksum"] for r in results}
    if len(sums) != 1 or not all(np.isfinite(v) for v in r0["dp"]["metrics"].values()):
        raise AssertionError(f"dp leg: ranks differ or non-finite metrics: {r0['dp']}")
    print(f"dryrun_multichip dp OK: mesh={r0['dp']['mesh']} routes={r0['dp']['routes']} "
          f"d_loss={r0['dp']['metrics']['d_loss']:.4f} g_loss={r0['dp']['metrics']['g_loss']:.4f}")
    base = r0["gspmd"][0]["checksum"]
    for leg in r0["gspmd"]:
        rel = abs(leg["checksum"] - base) / max(1e-12, abs(base))
        if not (np.isfinite(leg["g_loss"]) and rel < GSPMD_REL):
            raise AssertionError(f"gspmd leg {leg['mesh']}: checksum rel-delta {rel:.3e}")
        print(f"dryrun_multichip GSPMD (full U-Net) OK: mesh={leg['mesh']} "
              f"g_loss={leg['g_loss']:.4f} param_checksum={leg['checksum']:.9f} "
              f"rel-delta {rel:.3e}")
    if "pp" in r0:
        pp = r0["pp"]
        if not (pp["max_param_delta"] < PP_ATOL
                and abs(pp["rec_loss"] - pp["ref_loss"]) <= 1e-5 * abs(pp["ref_loss"])):
            raise AssertionError(f"pp leg: {pp}")
        print(f"dryrun_multichip pipeline parallel OK: pp=2 GPipe (4 microbatches) vs "
              f"single-device supervised update: max param delta {pp['max_param_delta']:.3e}, "
              f"rec_loss {pp['rec_loss']:.4f}")
    if n_devices >= 2 and n_devices % 2 == 0:
        with tempfile.TemporaryDirectory() as tmp:
            rel = _lockstep(n_devices, tmp)
        if not rel < LOCKSTEP_REL:
            raise AssertionError(f"lockstep leg: checksum rel-delta {rel:.3e}")
        r0["lockstep_rel"] = rel
        print(f"dryrun_multichip 2-launch lockstep OK: 2 x {n_devices // 2} ranks vs 1 x "
              f"{n_devices}: checksum rel-delta {rel:.3e}")
    return r0


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
