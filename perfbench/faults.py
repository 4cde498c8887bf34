"""Faults planted under the timed path, to show that the comparison that
decides ``correct`` catches them (``perfbench/tests`` and
``perfbench.calibrate``; the benchmark's own runs plant none):

* ``unchanged``: a step that leaves the models' state unchanged (no
  optimizer update is applied);
* ``half_batch``: half of the batch left out, every mean taken over the
  rest;
* ``altered``: an answer altered where it is produced: the first
  sixteenth of every noisy frame (one sample at L = 16, 64 at L = 1024)
  zeroed as the step draws its batch.

The cells run on one chip, so the fault of an exchange between chips left
out does not apply.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def plant(fault: str | None):
    """Patch the port's step with ``fault`` (``None``: nothing) while the
    block runs."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, not {fault!r}")
    from ofdmgan_tpu_torch.training import wgan_gp

    step_cls = wgan_gp.TrainStep
    saved = {"apply": wgan_gp._apply_grads, "run": step_cls.run,
             "draw_batch": step_cls.draw_batch}
    if fault == "unchanged":
        wgan_gp._apply_grads = lambda *args, **kwargs: None
    elif fault == "half_batch":
        def run(self, batch0, alphas, critic_batches=None):
            h = self.batch_size // 2
            return saved["run"](self, {k: v[:h] for k, v in batch0.items()},
                                [a[:h] for a in alphas], critic_batches)
        step_cls.run = run
    else:
        def draw_batch(self, rng):
            out = dict(saved["draw_batch"](self, rng))
            noisy = out["noisy"].clone()
            noisy[:, :max(1, noisy.shape[1] // 16), :] = 0.0
            out["noisy"] = noisy
            return out
        step_cls.draw_batch = draw_batch
    try:
        yield
    finally:
        wgan_gp._apply_grads = saved["apply"]
        step_cls.run, step_cls.draw_batch = saved["run"], saved["draw_batch"]
