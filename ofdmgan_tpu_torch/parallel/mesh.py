"""The device mesh and the explicit data-parallel CWGAN-GP step.

Counterpart of ``ofdmgan_tpu/parallel/mesh.py:38-141``. There, a
``jax.sharding.Mesh`` names the chips' axes and ``shard_map`` runs the fused
step on each replica with ``pmean`` collectives. Here a mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of the process group
(one rank a device), with the named axes ``dp``, ``tp``, ``sp`` and ``pp``,
and the data-parallel step is ``TrainStep`` on every rank with a ``shard``
that averages the gradients and metrics over ``dp``:

* each rank draws ``global_batch // dp`` frames from its own
  ``torch.Generator``, seeded from the step's seed and the rank's ``dp``
  coordinate (``fold_device_seed``, the counterpart of ``fold_device_key``),
  so the global batch is a disjoint, deterministic set of frames whatever
  the process layout;
* before each of the ``n_critic`` critic updates and before the generator
  update, the gradients and the metrics go into one flat buffer, which one
  ``all_reduce`` sums over ``dp`` and the rank divides by ``dp`` (the
  reference's ``pmean`` of ``(grads, aux)``, ``wgan_gp.py:274-277, 352``),
  so every replica applies the same update and stays bit-identical.

``DistributedDataParallel`` is not used: its reducer fires on
``.backward()``, and the critic-gradient kernel produces its gradients
without autograd. Routes stay by scope, so each rank runs the datagen
kernel once an outer step and the critic kernel ``n_critic`` times where
they cover the configuration.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from . import distributed
from ..signal.datagen import DatagenConfig
from ..training.wgan_gp import LossConfig, TrainStep

AXES = ("dp", "tp", "sp", "pp")
_MASK64 = (1 << 64) - 1


def make_mesh(axis_sizes: Optional[Mapping[str, int]] = None):
    """A ``DeviceMesh`` over every rank with the named axes of
    ``axis_sizes`` (default: all ranks on ``dp``), e.g. ``{"dp": 4, "tp":
    2}``. Raises where the axes' product is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    world = distributed.world_size()
    if axis_sizes is None:
        axis_sizes = {"dp": world}
    unknown = set(axis_sizes) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)} (expected some of {AXES})")
    n = math.prod(axis_sizes.values())
    if n > world:
        raise ValueError(f"mesh {dict(axis_sizes)} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh {dict(axis_sizes)} covers {n} of the {world} ranks")
    if not distributed.is_initialized():
        raise RuntimeError("a mesh needs the process group: call distributed.initialize")
    device_type = "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(axis_sizes.values()),
                            mesh_dim_names=tuple(axis_sizes))


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis``; 1 where the mesh lacks it."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``; 0 where the mesh lacks it."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(axis) if axis in names else 0


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis`` (``None`` where
    the mesh lacks the axis)."""
    return mesh.get_group(axis) if axis in (mesh.mesh_dim_names or ()) else None


def fold_device_seed(seed: int, index: int) -> int:
    """A replica's seed: ``index`` (its mesh coordinate) folded into the
    step's ``seed`` by a 64-bit mix (splitmix64's finalizer), so replicas
    draw disjoint streams and the same replica the same stream in any
    process layout."""
    z = (seed * 0x9E3779B97F4A7C15 + index + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def replica_generator(seed: int, index: int, device: torch.device) -> torch.Generator:
    """The ``torch.Generator`` of replica ``index`` for the step ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_device_seed(seed, index))
    return gen


def mean_flat(grads: Sequence[torch.Tensor], metrics: Dict[str, torch.Tensor], group,
              n: int) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The mean over ``group`` (``n`` ranks) of ``grads`` and ``metrics``:
    one flat buffer, one ``all_reduce``; the gradients come back as views
    of it. ``group`` ``None`` (a mesh without the axis) leaves them as
    they are."""
    if group is None:
        return list(grads), metrics
    dtype = grads[0].dtype
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [m.reshape(1).to(dtype) for m in metrics.values()])
    distributed.all_reduce(flat, group)
    flat.div_(n)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view(g.shape))
        i += g.numel()
    means = {k: flat[i + j].to(m.dtype) for j, (k, m) in enumerate(metrics.items())}
    return out, means


class MeshShard:
    """``TrainStep``'s ``shard`` over a mesh: the mean of the gradients and
    metrics over ``dp`` before each update. With ``modules`` (the gspmd
    step's models) each rank also holds its ``sp`` slice of every frame's
    length: the gradients of every convolution of ``modules`` are partial
    and summed over ``sp`` first, and the per-frame sums and the L1 mean are
    summed over ``sp``. Without them (the data-parallel step), or with ``sp``
    1, every rank holds whole frames."""

    def __init__(self, mesh, modules: Sequence[nn.Module] = ()):
        self.dp_group, self.dp = axis_group(mesh, "dp"), axis_size(mesh, "dp")
        self.sp_group, self.sp = axis_group(mesh, "sp"), axis_size(mesh, "sp") if modules else 1
        if self.sp == 1:
            self.frame_sum, self.mean = None, torch.mean
        else:
            self.partial = {id(m): [isinstance(m.get_submodule(n.rsplit(".", 1)[0]), nn.Conv1d)
                                    for n, _ in m.named_parameters()] for m in modules}

    def frame_sum(self, t: torch.Tensor) -> torch.Tensor:
        return distributed.ReduceFromGroup.apply(t.reshape(t.shape[0], -1).sum(1), self.sp_group)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        return distributed.ReduceFromGroup.apply(t.mean(), self.sp_group) / self.sp

    def reduce(self, module: nn.Module, grads, metrics):
        grads = list(grads)
        if self.sp > 1:
            idx = [i for i, partial in enumerate(self.partial[id(module)]) if partial]
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            distributed.all_reduce(flat, self.sp_group)
            off = 0
            for i in idx:
                grads[i] = flat[off:off + grads[i].numel()].view(grads[i].shape)
                off += grads[i].numel()
        return mean_flat(grads, metrics, self.dp_group, self.dp)


def draw_seed(seeds: torch.Generator) -> int:
    """The next step's seed from the host generator ``seeds``."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=seeds))


class ShardedTrainStep:
    """The data-parallel step of ``make_sharded_train_step``: ``step(seeds)``
    takes the step's seed from the host generator ``seeds`` (seeded alike on
    every rank), draws this replica's frames from ``replica_generator(seed,
    dp index)`` and takes the step; ``run(...)`` takes it on given draws, as
    ``TrainStep.run``. Other attributes are the ``TrainStep``'s."""

    def __init__(self, step: TrainStep, mesh):
        self.step, self.mesh = step, mesh
        self.dp_index = axis_index(mesh, "dp")

    def __call__(self, seeds: torch.Generator) -> Dict[str, torch.Tensor]:
        device = next(self.step.generator.parameters()).device
        return self.step(replica_generator(draw_seed(seeds), self.dp_index, device))

    def __getattr__(self, name):
        if "step" not in self.__dict__:   # while unpickling or copying
            raise AttributeError(name)
        return getattr(self.step, name)


def make_sharded_train_step(generator: nn.Module, critic: nn.Module, opt_g, opt_d,
                            dg_cfg: DatagenConfig, loss_cfg: LossConfig,
                            global_batch_size: int, mesh, **step_kw) -> ShardedTrainStep:
    """The data-parallel outer step over ``mesh``'s ``dp`` axis on this
    rank's replica of ``generator``/``critic`` and their optimizers (every
    rank must hold the same state: ``replicate_state``). ``step_kw`` are
    ``TrainStep``'s other settings. Any other mesh axis only replicates the
    step, as in the reference."""
    dp = axis_size(mesh, "dp")
    if global_batch_size % dp:
        raise ValueError(f"global batch {global_batch_size} not divisible by dp={dp}")
    step = TrainStep(generator, critic, opt_g, opt_d, dg_cfg, loss_cfg, global_batch_size // dp,
                     shard=MeshShard(mesh), **step_kw)
    return ShardedTrainStep(step, mesh)


def replicate_state(modules: Sequence[nn.Module], optimizers: Sequence = ()) -> None:
    """Rank 0's parameters and optimizer states on every rank (broadcast in
    place; the counterpart of placing one host state replicated on the
    mesh). Every rank must hold states of the same structure."""
    tensors = [p.data for m in modules for p in m.parameters()]
    for opt in optimizers:
        torch_opt = getattr(opt, "opt", opt)
        for group in torch_opt.param_groups:
            for p in group["params"]:
                tensors += [v for _, v in sorted(torch_opt.state.get(p, {}).items())
                            if isinstance(v, torch.Tensor)]
    distributed.replicate_global(tensors, src=0)
