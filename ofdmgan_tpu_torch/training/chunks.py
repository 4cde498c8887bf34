"""Scan chunks: ``scan_steps`` outer steps per dispatch.

Counterpart of the reference's ``scan_steps`` (``ofdmgan_tpu/training/
wgan_gp.py:401-420``, ``trainer.py:99-104``): each dispatch runs K outer
steps and reports the metrics of its last one. ``chunk_size`` is the
reference's choice of K. ``EagerChunk`` runs the K steps one by one;
``GraphedChunk`` runs them as one CUDA graph, replayed once per chunk.

A graphed chunk is captured after one eager chunk on a side stream (the
``torch.cuda.graph`` recipe's warm-up; it is the first chunk of training,
not an extra one), with cuDNN's benchmarking off, and every step of the
chunk (the datagen, each kernel or plain route, both optimizers' updates)
is in the graph. The step's ``torch.Generator`` is registered with the
graph, so each replay draws the numbers that eager steps would draw from
the generator's state at that point, and advances it as they would. The
optimizers must hold their schedules on the device
(``AdamStepLR.hold_on_device``). The kernels' launch counters count the
launches their wrappers run; a capture records launches without running
them and a replay calls no wrapper, so neither moves a counter: the
launches a replay runs show in a profiler's trace of it. A capture that
fails raises; a graph whose tensors the trainer replaced (a resume, a warm
start) is captured again after ``reset()``.

Spans (``utils/spans.py``) time an eager chunk's call and a replay on the
host (``chunk``) and every capture (``chunk.capture``, kept with spans off
too); a capture taken with spans on holds the step's spans' device events,
which each replay records again.

The reference unrolls its outer scan by ``outer_unroll`` ("pure codegen,
identical numerics", ``wgan_gp.py:207-214``) and its critic scan by
``critic_unroll``. An eager chunk runs its steps one by one and a graphed
one replays the kernels they launched, so neither has a scan to unroll:
both settings are accepted by the entry points that take them
(``ofdmgan_tpu_torch.bench``, the trainer's ``critic_unroll``) and change
nothing.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..utils import spans

MAX_SCAN_STEPS = 32


def chunk_size(steps_per_epoch: int, scan_steps: int = 0) -> int:
    """K: ``scan_steps``, or ``min(steps_per_epoch, 32)`` where it is 0,
    lowered until it divides the epoch (reference ``trainer.py:99-104``)."""
    k = scan_steps if scan_steps > 0 else min(steps_per_epoch, MAX_SCAN_STEPS)
    while steps_per_epoch % k:
        k -= 1
    return k


class EagerChunk:
    """K outer steps of ``step`` from ``rng``, one by one; returns the last
    step's metrics."""

    def __init__(self, step: Callable, rng: torch.Generator, k: int):
        self.step, self.rng, self.k = step, rng, k

    def __call__(self) -> Dict[str, torch.Tensor]:
        with spans.host_span("chunk"):
            for _ in range(self.k):
                metrics = self.step(self.rng)
        return metrics

    def reset(self) -> None:
        pass


class GraphedChunk:
    """K outer steps of ``step`` from the CUDA generator ``rng`` as one CUDA
    graph (see the module's docstring)."""

    def __init__(self, step, rng: torch.Generator, k: int):
        if rng.device.type != "cuda":
            raise ValueError("a graphed chunk needs a CUDA generator")
        for opt in (step.opt_g, step.opt_d):
            if not opt.on_device:
                raise ValueError("a graphed chunk needs optimizers that hold their schedule "
                                 "on the device (AdamStepLR.hold_on_device)")
        self.step, self.rng, self.k = step, rng, k
        self.eager = EagerChunk(step, rng, k)
        self.reset()

    def reset(self) -> None:
        """Capture again at the next chunk that follows a warm-up chunk."""
        self.graph, self.metrics, self.warm = None, None, False

    def _warm_up(self) -> Dict[str, torch.Tensor]:
        main = torch.cuda.current_stream(self.rng.device)
        side = torch.cuda.Stream(self.rng.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            metrics = self.eager()
        main.wait_stream(side)
        self.warm = True
        return metrics

    def capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.rng)
        benchmark = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False
        try:
            with spans.setup_span("chunk.capture"), torch.cuda.graph(graph):
                metrics = self.eager()
        finally:
            torch.backends.cudnn.benchmark = benchmark
        self.graph, self.metrics = graph, metrics

    def replay(self) -> Dict[str, torch.Tensor]:
        with spans.host_span("chunk"):
            self.graph.replay()
        return self.metrics

    def __call__(self) -> Dict[str, torch.Tensor]:
        """One chunk: the warm-up chunk, else (after the capture, at the
        first call past it) a replay. The metrics are the graph's own
        tensors, which the next replay overwrites."""
        if self.graph is None:
            if not self.warm:
                return self._warm_up()
            self.capture()
        return self.replay()
