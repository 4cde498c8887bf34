#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from ``ofdmgan_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, trains the mini CWGAN-GP for
two short epochs through both kernels with ``Trainer``, and checks that the
kernel path and the plain path take the same step. Every phase prints one
JSON line with its wall seconds as it ends. Any failed check raises, and the
script exits non-zero. The last lines are the kernel table, the card's name
and power limit, and the result line.

Tolerances: the datagen kernel against its plain version rtol 1e-5,
atol 1e-6 (the same float32 arithmetic; only the order of a few sums and the
rounding of fused multiply-adds differ). The critic-gradient kernel against
its plain version and against autograd rtol 1e-4, atol 1e-4 times the
tensor's largest entry: the batch sums are taken in another order. One
outer step through the kernels and one through the plain path (FFT datagen,
autograd critic) from the same state and draws: each parameter tensor's
update agrees within 1e-3 of that update's largest entry. The kernel table gives each kernel's time, plain time and error at the main
path's batch (64); the phase lines give them at every batch checked.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, float32 outside the tensor cores
MAIN_B = 64                 # the mini recipe's batch (config/config.yaml)
DATAGEN_BIG_B = 1 << 20
CRITIC_BIG_B = 65536
CRITIC_RAGGED_B = 1000      # not a multiple of the kernel's 16-row tile
CRITIC_PARAMS = 521         # the mini critic's parameters, one gradient each
STEP_RTOL = 1e-3            # kernel vs plain outer step, of each tensor's largest update


def log(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3), **fields}),
          flush=True)


def time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got: dict, ref: dict, keys) -> float:
    return max(float((got[k] - ref[k]).abs().max()) for k in keys)


def check_close(got, ref, rtol, atol, what):
    if not torch.allclose(got, ref, rtol=rtol, atol=atol):
        err = float((got - ref).abs().max())
        raise AssertionError(f"{what}: max abs error {err:.3e} (rtol {rtol}, atol {atol:.3e})")


def datagen_bound_ms(b: int, L: int) -> tuple[float, str]:
    """Least time for one Philox-mode call: the outputs the training step
    reads written once (noisy, clean, snr; not the normaliser ``scale``)
    against the IDFT's 8 L^2 FLOP per frame plus about 30 per sample for the
    draws, impairments and noise."""
    t_bytes = b * (2 * 2 * L + 1) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = b * (8 * L * L + 30 * L) / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def critic_macs_per_frame() -> int:
    """Multiply-adds per frame of one critic-gradient evaluation. Of its 18
    products with a layer matrix (6 forward, 6 Wasserstein backward, 6
    gradient-penalty), 8 use A1 and 10 use A2. Both are block-Toeplitz
    expansions of small convolutions, so each product needs only the
    matrix's non-zeros (the conv taps that fall inside the frame), not its
    dense 64 x 64."""
    from ofdmgan_tpu_torch.ops.dense_conv import conv1d_dense_matrix
    nz1 = int(conv1d_dense_matrix(torch.ones(8, 4, 3), 16, 2, 1).count_nonzero())
    nz2 = int(conv1d_dense_matrix(torch.ones(16, 8, 3), 8, 2, 1).count_nonzero())
    return 8 * nz1 + 10 * nz2


def critic_bound_ms(b: int) -> tuple[float, str]:
    """Least time for one call: the inputs (two [B, 64] rows, eps, the
    critic's parameters) read once and one gradient per parameter plus
    three metric sums written once, against 2 FLOP per multiply-add."""
    t_bytes = (b * (2 * 64 + 1) + 2 * CRITIC_PARAMS + 3) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = b * 2 * critic_macs_per_frame() / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    t0 = time.time()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", t0, device=kind, count=torch.cuda.device_count(), nvidia_smi=card,
        torch=torch.__version__, cuda=torch.version.cuda)

    from ofdmgan_tpu_torch.config import Config
    from ofdmgan_tpu_torch.device import resolve_device
    from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
    from ofdmgan_tpu_torch.ops import build, critic_kernel as ck, datagen_kernel as dk
    from ofdmgan_tpu_torch.signal import datagen as sdg
    from ofdmgan_tpu_torch.signal.impairments import ImpairmentConfig
    from ofdmgan_tpu_torch.training.schedules import make_adam
    from ofdmgan_tpu_torch.training.trainer import Trainer
    from ofdmgan_tpu_torch.training.wgan_gp import LossConfig, TrainStep, critic_loss_fn

    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    # ---- 1. build
    t = time.time()
    logs = build.build()
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line or "Compiling" in line):
                print(f"[{name}] {line.strip()}", flush=True)
    log("build", t, built=[n for n, txt in logs.items() if txt], build_s=round(time.time() - t, 3))

    # ---- 2. datagen kernel against its plain version
    t = time.time()
    cfgs = {False: sdg.DatagenConfig(),
            True: sdg.DatagenConfig(nonlinear=True, impairments=ImpairmentConfig(pa_saturation=0.8))}
    keys = ("noisy", "clean", "snr", "scale")
    datagen_err = {}   # worst error over both configurations, by batch size
    for b in (MAIN_B, DATAGEN_BIG_B):
        for nl, cfg in cfgs.items():
            draws = sdg.make_draws(gen, b, 16)
            got = dk.synthetic_batch_from_draws(draws, cfg)
            ref = dk.synthetic_batch_plain(draws, cfg)
            torch.cuda.synchronize()
            for k in keys:
                check_close(got[k], ref[k], 1e-5, 1e-6, f"datagen B={b} nonlinear={nl} {k}")
            datagen_err[b] = max(datagen_err.get(b, 0.0), max_err(got, ref, keys))
            del draws, got, ref
    out = dk.synthetic_batch(gen, DATAGEN_BIG_B, cfgs[False])
    snr = out["snr"]
    p_clean = (out["clean"] ** 2).sum((1, 2)) / 16
    p_noise = ((out["noisy"] - out["clean"]) ** 2).sum((1, 2)) / 16
    stats = {
        "snr_min": float(snr.min()), "snr_max": float(snr.max()), "snr_mean": float(snr.mean()),
        "clean_power_mean": float((p_clean * out["scale"] ** 2).mean()),
        "noise_ratio_over_target": float((p_noise / p_clean / 10 ** (-snr / 10)).mean()),
    }
    if not (stats["snr_min"] >= 0 and stats["snr_max"] <= 30 and abs(stats["snr_mean"] - 15) < 0.1):
        raise AssertionError(f"datagen SNR statistics off: {stats}")
    if abs(stats["clean_power_mean"] - 1) > 0.01 or abs(stats["noise_ratio_over_target"] - 1) > 0.01:
        raise AssertionError(f"datagen power statistics off: {stats}")
    out_nl = dk.synthetic_batch(gen, DATAGEN_BIG_B, cfgs[True])
    if not all(bool(torch.isfinite(v).all()) for v in out_nl.values()):
        raise AssertionError("nonlinear datagen produced non-finite values")
    del out, out_nl
    dg_times = {}
    for b in (MAIN_B, DATAGEN_BIG_B):
        draws = sdg.make_draws(gen, b, 16)
        dg_times[b] = {
            "ms": time_ms(lambda: dk.synthetic_batch(gen, b, cfgs[False])),
            "plain_ms": time_ms(lambda: dk.synthetic_batch_plain(draws, cfgs[False])),
            "bound_ms": datagen_bound_ms(b, 16)[0],
        }
        del draws
    log("datagen", t, max_abs_err=datagen_err, stats=stats, times=dg_times)

    # ---- 3. critic-gradient kernel against its plain version and autograd
    t = time.time()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        critic = MiniDiscriminator().to(dev)
        generator = MiniGenerator().to(dev)
    critic_err = {}
    cr_times = {}
    for b in (MAIN_B, CRITIC_BIG_B, CRITIC_RAGGED_B):
        clean = torch.randn(b, 16, 2, generator=gen, device=dev)
        noisy = clean + 0.3 * torch.randn(b, 16, 2, generator=gen, device=dev)
        eps = torch.rand(b, generator=gen, device=dev)
        with torch.no_grad():
            fake = generator(noisy)
        h0r, h0f = ck.pack_h0(clean, noisy), ck.pack_h0(fake, noisy)
        mats = ck.critic_dense_mats(critic)
        got = ck.critic_grad_dense(h0r, h0f, eps, mats, 10.0)
        ref = ck.critic_grad_plain(h0r, h0f, eps, mats, 10.0)
        torch.cuda.synchronize()
        for k in ref:
            check_close(got[k], ref[k], 1e-4, 1e-4 * float(ref[k].abs().max()), f"critic B={b} {k}")
            critic_err[b] = max(critic_err.get(b, 0.0), float((got[k] - ref[k]).abs().max()))
        grads, aux = ck.critic_grad(critic, h0r, h0f, eps, 10.0)
        loss, aux_ref = critic_loss_fn(critic, generator, {"noisy": noisy, "clean": clean}, eps,
                                       LossConfig())
        grads_ref = torch.autograd.grad(loss, list(critic.parameters()))
        for (name, _), g_ref in zip(critic.named_parameters(), grads_ref):
            check_close(grads[name], g_ref, 1e-4, 1e-4 * float(g_ref.abs().max()) + 1e-7,
                        f"critic B={b} {name} vs autograd")
        for name in aux_ref:
            check_close(aux[name], aux_ref[name], 1e-4, 1e-5, f"critic B={b} {name}")
        if b != CRITIC_RAGGED_B:
            def autograd_step():
                loss, _ = critic_loss_fn(critic, generator, {"noisy": noisy, "clean": clean},
                                         eps, LossConfig())
                torch.autograd.grad(loss, list(critic.parameters()))
            cr_times[b] = {
                "ms": time_ms(lambda: ck.critic_grad_dense(h0r, h0f, eps, mats, 10.0)),
                "plain_ms": time_ms(lambda: ck.critic_grad_plain(h0r, h0f, eps, mats, 10.0)),
                "autograd_ms": time_ms(autograd_step),
                "bound_ms": critic_bound_ms(b)[0],
            }
    log("critic", t, max_abs_err=critic_err, times=cr_times)

    # ---- 4. train through both kernels with the config defaults
    t = time.time()
    cfg = Config(checkpoint_dir="build/chip_smoke/checkpoints", log_dir="build/chip_smoke/logs")
    steps = 20
    trainer = Trainer(cfg, samples_per_epoch=steps * cfg.training.batch_size, val_samples=256,
                      seed=0, device="cuda")
    dk.launches = 0
    ck.launches = 0
    t_train = time.time()
    history = trainer.train(epochs=2, experiment_name="chip_smoke")
    torch.cuda.synchronize()
    train_s = time.time() - t_train
    launches = {"datagen": dk.launches, "critic_grad": ck.launches}
    if launches["datagen"] <= 0 or launches["critic_grad"] <= 0:
        raise AssertionError(f"the training run did not go through both kernels: {launches}")
    if not all(math.isfinite(v) for rec in history for v in rec.values()) or len(history) != 2:
        raise AssertionError(f"non-finite or missing training metrics: {history}")

    # one outer step from the trained state through the kernel path and the
    # plain path (FFT datagen, autograd critic), on the same draws and
    # penalty uniforms; each tensor's update must agree within STEP_RTOL of
    # that update's largest entry
    def clone_step(reference: bool) -> TrainStep:
        g, d = copy.deepcopy(trainer.generator), copy.deepcopy(trainer.critic)
        tr = cfg.training
        opt_g = make_adam(g.parameters(), tr.lr_generator, tr.betas, 1)
        opt_d = make_adam(d.parameters(), tr.lr_discriminator, tr.betas, 1)
        for new, old in ((opt_g, trainer.opt_g), (opt_d, trainer.opt_d)):
            new.opt.load_state_dict(copy.deepcopy(old.opt.state_dict()))
            new.sched.load_state_dict(old.sched.state_dict())
        return TrainStep(g, d, opt_g, opt_d, trainer.dg_cfg, trainer.loss_cfg, MAIN_B,
                         reference=reference)

    draws = sdg.make_draws(gen, MAIN_B, 16)
    alphas = [torch.rand(MAIN_B, generator=gen, device=dev) for _ in range(5)]
    step_k, step_p = clone_step(False), clone_step(True)
    start = {n: p.detach().clone() for n, p in step_k.generator.named_parameters()}
    start.update({f"critic.{n}": p.detach().clone() for n, p in step_k.critic.named_parameters()})
    m_k = step_k.run(dk.synthetic_batch_from_draws(draws, trainer.dg_cfg), alphas)
    m_p = step_p.run(sdg.synthetic_batch_from_draws(draws, trainer.dg_cfg), alphas)

    def after(step):
        return {**dict(step.generator.named_parameters()),
                **{f"critic.{n}": p for n, p in step.critic.named_parameters()}}

    step_diff, step_rel = 0.0, 0.0
    after_k, after_p = after(step_k), after(step_p)
    for name, p0 in start.items():
        upd_k, upd_p = (after_k[name] - p0).detach(), (after_p[name] - p0).detach()
        diff, size = float((upd_k - upd_p).abs().max()), float(upd_p.abs().max())
        if diff > STEP_RTOL * size + 1e-9:
            raise AssertionError(f"kernel and plain steps differ on {name}: {diff:.3e} against "
                                 f"a largest update of {size:.3e} (limit {STEP_RTOL} of it)")
        step_diff = max(step_diff, diff)
        step_rel = max(step_rel, diff / size if size else 0.0)
    log("train", t, launches=launches, train_s=round(train_s, 3), history=history,
        step_update_max_abs_diff=step_diff, step_update_max_rel_diff=step_rel,
        step_metrics_kernel={k: float(v) for k, v in m_k.items()},
        step_metrics_plain={k: float(v) for k, v in m_p.items()})

    # ---- 5. report
    db, dby = datagen_bound_ms(MAIN_B, 16)
    cb, cby = critic_bound_ms(MAIN_B)
    kernels = [
        {"name": "datagen", "route": "cuda", "source": "ofdmgan_tpu_torch/csrc/datagen.cu",
         "replaces": "ofdmgan_tpu/ops/pallas_datagen.py:200", "launches": launches["datagen"],
         "max_abs_err": datagen_err[MAIN_B], "ms": dg_times[MAIN_B]["ms"],
         "plain_ms": dg_times[MAIN_B]["plain_ms"], "bound_ms": db, "bound_by": dby,
         "library_ms": None},
        {"name": "critic_grad", "route": "cuda", "source": "ofdmgan_tpu_torch/csrc/critic_grad.cu",
         "replaces": "ofdmgan_tpu/ops/pallas_critic.py:195", "launches": launches["critic_grad"],
         "max_abs_err": critic_err[MAIN_B], "ms": cr_times[MAIN_B]["ms"],
         "plain_ms": cr_times[MAIN_B]["plain_ms"], "bound_ms": cb, "bound_by": cby,
         "library_ms": None},
    ]
    log("total", t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
