"""Adam with a staircase StepLR counted in optimizer updates.

Counterpart of ``ofdmgan_tpu/training/schedules.py:15-33``: Adam with
betas (0.0, 0.9) and eps 1e-8, the learning rate multiplied by ``gamma``
after every ``updates_per_decay`` updates.

An ``AdamStepLR`` steps a host ``StepLR`` until ``hold_on_device()``; from
then on the rate is a 0-d float32 tensor on the parameters' device,
computed there before each update from a device count of updates,
``lr0 * gamma ** floor(n / updates_per_decay)`` (optax's staircase
``exponential_decay``), and Adam is ``capturable`` on CUDA: an update then
reads no device value on the host, so a CUDA graph can hold it (the rate
may change in the middle of a graphed chunk). ``state_dict()`` gives both
modes' state in the host mode's form (a float rate, steps on the host),
the checkpoints' format.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


def step_lr_rate(count: torch.Tensor, lr0: float, updates_per_decay: int,
                 gamma: float) -> torch.Tensor:
    """``lr0 * gamma ** floor(count / updates_per_decay)`` in float32, on
    ``count``'s device (``count``: an integer tensor of updates done)."""
    k = torch.div(count, max(1, updates_per_decay), rounding_mode="floor")
    return torch.pow(gamma, k) * lr0   # no host tensor: the rate is computed in a CUDA graph


class AdamStepLR:
    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 betas=(0.0, 0.9), updates_per_decay: int | None = None,
                 gamma: float = 0.5):
        self.opt = torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=1e-8)
        self.sched = (torch.optim.lr_scheduler.StepLR(self.opt, max(1, updates_per_decay), gamma)
                      if updates_per_decay is not None else None)
        self.lr0 = lr
        self.count: Optional[torch.Tensor] = None   # updates done, once on the device

    @property
    def on_device(self) -> bool:
        return self.count is not None

    def hold_on_device(self) -> "AdamStepLR":
        """Move the schedule's state onto the parameters' device (see the
        module's docstring); a no-op when it is there."""
        if self.on_device:
            return self
        group = self.opt.param_groups[0]
        dev = group["params"][0].device
        n = self.sched.last_epoch if self.sched is not None else 0
        self.count = torch.tensor(n, dtype=torch.int64, device=dev)
        group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32, device=dev)
        group["capturable"] = dev.type == "cuda"
        if group["capturable"]:
            for st in self.opt.state.values():
                st["step"] = st["step"].to(dev, torch.float32)
        return self

    def step(self) -> None:
        """One Adam update with the current gradients, then advance the schedule."""
        if not self.on_device:
            self.opt.step()
            if self.sched is not None:
                self.sched.step()
            return
        if self.sched is not None:
            self.opt.param_groups[0]["lr"].copy_(
                step_lr_rate(self.count, self.lr0, self.sched.step_size, self.sched.gamma))
        self.opt.step()
        self.count.add_(1)

    def state_dict(self) -> tuple:
        """(Adam's state dict, StepLR's or ``None``) in the host mode's form
        whatever the mode: the rate a float, ``capturable`` off, the step
        counts host tensors. Reads the device count on the host."""
        opt = self.opt.state_dict()
        if not self.on_device:
            return opt, None if self.sched is None else self.sched.state_dict()
        lr = float(self.opt.param_groups[0]["lr"])
        opt["param_groups"] = [dict(g, lr=lr, capturable=False) for g in opt["param_groups"]]
        opt["state"] = {k: dict(v, step=v["step"].detach().cpu())
                        for k, v in opt["state"].items()}
        sched = None
        if self.sched is not None:
            sched = dict(self.sched.state_dict(), last_epoch=int(self.count), _last_lr=[lr])
        return opt, sched

    def load_state_dict(self, opt: dict, sched: Optional[dict]) -> None:
        """Restore ``state_dict()``'s output (the host mode's form) in this
        optimizer's mode."""
        device_mode = self.on_device
        self.count = None
        self.opt.load_state_dict(opt)
        if self.sched is not None and sched is not None:
            self.sched.load_state_dict(sched)
        if device_mode:
            self.hold_on_device()


make_adam = AdamStepLR  # the reference's name (schedules.py:25)
