"""The six model self-checks of the original repository's ``test_models.py``:
``python -m ofdmgan_tpu_torch.model_selftest`` (counterpart of the root
``test_models.py``; named so that pytest does not collect it).

Generator forward, discriminator forward, the training configuration's
defaults (``config.Config``, the values of ``config/config.yaml``; the port
reads no YAML unless asked), the parameter counts (258 and 521), gradient
flow through both models, and the channel progression the RTL implements.
Prints one line per check and exits 0 when all pass, 1 otherwise. Runs on
the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Model self-checks (exit 0: all passed)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .config import Config
    from .device import resolve_device
    from .models import MiniDiscriminator, MiniGenerator, count_parameters

    dev = resolve_device(args.device)
    gen_rng = torch.Generator().manual_seed(0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gen, disc = MiniGenerator().to(dev), MiniDiscriminator().to(dev)
    x = torch.randn(2, 16, 2, generator=gen_rng).to(dev)
    results = []

    def check(name, fn):
        try:
            fn()
            print(f"  [PASS] {name}")
            results.append(True)
        except Exception as e:  # noqa: BLE001  (every failure is reported, then counted)
            print(f"  [FAIL] {name}: {e}")
            results.append(False)

    def test_generator():
        with torch.no_grad():
            y = gen(x)
        assert tuple(y.shape) == (2, 16, 2), tuple(y.shape)
        assert float(y.abs().max()) <= 1.0

    def test_discriminator():
        with torch.no_grad():
            s = disc(x, x)
        assert tuple(s.shape) == (2, 1), tuple(s.shape)

    def test_training_config():
        cfg = Config()
        assert cfg.frame_length == 16
        assert 0 < cfg.training.lr_generator < 1

    def test_parameter_count():
        ng, nd = count_parameters(gen), count_parameters(disc)
        assert ng == 258 and nd == 521, (ng, nd)

    def test_gradient_flow():
        fake = gen(x)
        loss = -disc(fake, x).mean() + (fake - x).abs().mean()
        grads = torch.autograd.grad(loss, [*gen.parameters(), *disc.parameters()],
                                    allow_unused=True)
        total = sum(float(g.abs().sum()) for g in grads if g is not None)
        assert torch.isfinite(torch.tensor(total)) and total > 0, total

    def test_rtl_compatibility():
        g = [gen.enc1.in_channels, gen.enc1.out_channels, gen.bottleneck.out_channels,
             gen.dec1.out_channels, gen.out_conv.out_channels]
        assert g == [2, 4, 8, 4, 2], g
        d = [disc.conv1.in_channels, disc.conv1.out_channels, disc.conv2.out_channels]
        assert d == [4, 8, 16], d

    print("Running model self-checks:")
    check("generator forward", test_generator)
    check("discriminator forward", test_discriminator)
    check("training config", test_training_config)
    check("parameter count (258/521)", test_parameter_count)
    check("gradient flow", test_gradient_flow)
    check("RTL channel-progression compatibility", test_rtl_compatibility)
    n_pass = sum(results)
    print(f"\n{n_pass}/{len(results)} tests passed")
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
