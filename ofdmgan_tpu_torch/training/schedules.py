"""Adam with a staircase StepLR counted in optimizer updates.

Counterpart of ``ofdmgan_tpu/training/schedules.py:15-33``: Adam with
betas (0.0, 0.9) and eps 1e-8, the learning rate multiplied by ``gamma``
after every ``updates_per_decay`` updates.
"""

from __future__ import annotations

from typing import Iterable

import torch


class AdamStepLR:
    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 betas=(0.0, 0.9), updates_per_decay: int | None = None,
                 gamma: float = 0.5):
        self.opt = torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=1e-8)
        self.sched = (torch.optim.lr_scheduler.StepLR(self.opt, max(1, updates_per_decay), gamma)
                      if updates_per_decay is not None else None)

    def step(self) -> None:
        """One Adam update with the current gradients, then advance the schedule."""
        self.opt.step()
        if self.sched is not None:
            self.sched.step()


make_adam = AdamStepLR  # the reference's name (schedules.py:25)
