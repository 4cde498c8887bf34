"""The multi-process runtime: process groups, local rank launches and the
collectives the parallel strategies use.

Counterpart of ``ofdmgan_tpu/parallel/distributed.py:33-88``, where
``jax.distributed`` joins one JAX process per host into a global device
view. Here every rank is one process, and ``torch.distributed`` joins them:

* ``initialize`` calls ``torch.distributed.init_process_group``: NCCL when
  the rank's device is CUDA, gloo when it is the CPU (or as the caller
  says). The rendezvous is ``tcp://<coordinator>`` when a coordinator is
  given, a ``file://`` store when a path is given, and torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) when no argument
  is given, as ``jax.distributed.initialize`` detects its cluster. A
  rendezvous that fails or times out raises; nothing carries on as a single
  process.
* Torch has no virtual devices. The JAX package tests multi-device code on
  one host with N virtual CPU devices a process; the port's counterpart,
  ``local_cpu_devices`` (``train.py --local_devices N``), is N ranks that
  one launch spawns on this host (``launch``: ``torch.multiprocessing`` with
  the spawn method, a ``file://`` store, gloo on the CPU).
* ``replicate_global`` broadcasts rank 0's tensors to every rank (the JAX
  package places one host value on every device); ``process_local_scalar``
  reads rank 0's value of a scalar on every rank.

The collectives (``all_reduce``, a sum or a maximum, ``broadcast``,
``all_gather``, ``send``, ``recv``) count the bytes they move in
``traffic``. NCCL refuses two ranks
on one GPU, so a single card runs its multi-rank legs over gloo, whose CUDA
support is ``all_reduce`` and ``broadcast`` alone: the helpers move every
other CUDA payload through host memory there, and count those bytes under
``traffic["staged_bytes"]``.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 120.0
# bytes of the payloads of every collective since the caller last set them
# to 0, and of the CUDA payloads moved through host memory on gloo
traffic = {"collective_bytes": 0, "staged_bytes": 0, "calls": 0}


def reset_traffic() -> None:
    for k in traffic:
        traffic[k] = 0


def backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU. Asking for CUDA where there
    is no GPU raises: nothing picks gloo in its place."""
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device and none is available; "
                               "pass device='cpu' for gloo on the CPU")
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, local_cpu_devices: Optional[int] = None,
               *, device: str | torch.device | None = None, backend: Optional[str] = None,
               local_rank: int = 0,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group and return this rank's device.

    ``coordinator_address`` (``host:port``, or a ``file://`` path that
    every launch can reach), ``num_processes`` and ``process_id`` name a
    rendezvous at ``tcp://coordinator_address`` (or that file);
    with ``local_cpu_devices`` N each process holds N ranks, so the world
    has ``num_processes * N`` ranks and this one is ``process_id * N +
    local_rank``. Without a coordinator, torchrun's environment is read. ``device`` is the rank's
    device (default: the GPU of its local rank); ``backend`` overrides the
    backend it implies (gloo on a CUDA device is how two ranks share one
    card)."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    per_process = local_cpu_devices or 1
    if coordinator_address is not None:
        world = (num_processes or 1) * per_process
        rank = (process_id or 0) * per_process + local_rank
        method = (coordinator_address if "://" in coordinator_address
                  else f"tcp://{coordinator_address}")
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", local_rank))
        method = "env://"
    else:
        raise RuntimeError("no rendezvous: pass a coordinator address (host:port or a "
                           "file:// path), or launch under torchrun (RANK, WORLD_SIZE, "
                           "MASTER_ADDR)")
    if device is None:
        device = f"cuda:{local_rank % max(1, torch.cuda.device_count())}"
    device = torch.device(device)
    if device.type == "cuda":
        backend_for(device)   # raises without a GPU
        torch.cuda.set_device(device)
    backend = backend or backend_for(device)
    dist.init_process_group(backend, init_method=method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (no-op in a single process)."""
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------- collectives
def _count(t: torch.Tensor, staged: bool, n: int = 1) -> None:
    nbytes = t.numel() * t.element_size() * n
    traffic["collective_bytes"] += nbytes
    traffic["calls"] += 1
    if staged:
        traffic["staged_bytes"] += 2 * nbytes   # to the host and back


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` must go through host memory: a CUDA tensor on gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Sum ``t`` over ``group`` in place, or with ``op="max"`` take its
    elementwise maximum (gloo and NCCL both take CUDA tensors here);
    returns ``t``."""
    _count(t, False)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=group)
    return t


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group``, in place."""
    _count(t, False)
    dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``[group size, *t.shape]``: every rank's ``t``, in group order."""
    n = dist.get_world_size(group)
    staged = _staged(t, group)
    src = t.detach().cpu() if staged else t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    _count(src, staged, n)
    dist.all_gather(out, src, group=group)
    gathered = torch.stack(out)
    return gathered.to(t.device) if staged else gathered


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """``t`` to global rank ``dst`` (a matching ``recv`` there)."""
    staged = _staged(t, group)
    _count(t, staged)
    dist.send(t.detach().cpu() if staged else t.detach().contiguous(), dst, group=group)


def recv(shape: Sequence[int], dtype: torch.dtype, device: torch.device, src: int,
         group=None) -> torch.Tensor:
    """A new tensor from global rank ``src``."""
    staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
    out = torch.empty(tuple(shape), dtype=dtype, device="cpu" if staged else device)
    _count(out, staged)
    dist.recv(out, src, group=group)
    return out.to(device) if staged else out


def replicate_global(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Every tensor of ``tensors`` in place from rank ``src`` (every rank
    passes tensors of the same shapes, in the same order)."""
    nccl = is_initialized() and dist.get_backend(group) == "nccl"
    with torch.no_grad():
        for t in tensors:
            if nccl and not t.is_cuda:   # Adam's step counts live on the host
                on_card = broadcast(t.cuda(), src, group)
                t.copy_(on_card)
            else:
                broadcast(t, src, group)


def process_local_scalar(x, group=None) -> float:
    """Rank 0's value of the scalar ``x``, read on every rank."""
    t = torch.as_tensor(x, dtype=torch.float64).reshape(1).clone()
    if is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend(group) == "nccl" else torch.device("cpu")
        t = broadcast(t.to(dev), 0, group).cpu()
    return float(t[0])


# ------------------------------------------------ differentiable collectives
class CopyToGroup(torch.autograd.Function):
    """Megatron's ``f``: identity forward, sum over ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ReduceFromGroup.apply(grad, ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """Megatron's ``g``: sum over ``group`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return CopyToGroup.apply(grad, ctx.group), None


# ---------------------------------------------------------- local launches
def _rank_main(local_rank: int, fn: Callable, args: tuple, nprocs: int, init_file: str,
               result_dir: str, device: str, backend: Optional[str], timeout_s: Optional[float],
               threads: Optional[int], coordinator: Optional[str], num_processes: Optional[int],
               process_id: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    if device == "cuda":   # one card a local rank, in turn
        device = f"cuda:{local_rank % max(1, torch.cuda.device_count())}"
    initialize(coordinator or f"file://{init_file}", num_processes, process_id, nprocs,
               device=device, backend=backend, local_rank=local_rank,
               timeout_s=timeout_s or DEFAULT_TIMEOUT_S)
    try:
        result = fn(*args)
        torch.save(_to_cpu(result), Path(result_dir) / f"rank{local_rank}.pt")
    finally:
        shutdown()


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def launch(fn: Callable, nprocs: int, args: tuple = (), *, device: str = "cpu",
           backend: Optional[str] = None, timeout_s: Optional[float] = DEFAULT_TIMEOUT_S,
           threads: Optional[int] = None, coordinator: Optional[str] = None,
           num_processes: Optional[int] = None, process_id: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``nprocs`` ranks spawned on this host and return
    each rank's return value (moved to the CPU), in local rank order.

    The ranks join a ``file://`` store, or with ``coordinator`` the
    rendezvous of ``num_processes`` launches, this one ``process_id``.
    ``device`` is every rank's device: the CPU (gloo), a CUDA device
    (NCCL unless ``backend`` says gloo), or ``"cuda"``, local rank r on
    card r modulo the count. ``fn`` must be importable by name (the spawn
    method pickles it). Raises with the failing rank's traceback if a rank
    fails, and ``TimeoutError``, after terminating every rank, if they have
    not all ended within ``timeout_s`` seconds (``None``: no limit; the
    rendezvous still times out after ``DEFAULT_TIMEOUT_S``). ``threads``
    sets each rank's torch threads."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, nprocs, os.path.join(tmp, "store"), tmp, device,
                              backend, timeout_s, threads, coordinator, num_processes,
                              process_id),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} ranks did not end within {timeout_s} s")
        except BaseException:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
            raise
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(nprocs)]
