"""The generator forward kernel's CUDA source run on the CPU.

``ofdmgan_tpu_torch/csrc/generator_forward.cu`` is built by g++ against
``tests/cuda_emulation.h`` (each CUDA thread an OS thread, barriers for
``__syncwarp`` and ``__syncthreads``) and its C entry point is called on CPU
tensors. This holds the thread logic (one thread a frame, the frames staged
through a padded tile), ragged last groups and the grid-stride loop (an
emulated card of one SM) against
the plain version ``generator_forward_plain`` at the card tests' tolerance
(``utils/kernel_checks.assert_forward_close``), on contiguous and strided
frames, and shows that a frame's fake does not depend on the batch around
it. Skips where g++ is missing.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from ofdmgan_tpu_torch.models import MiniGenerator
from ofdmgan_tpu_torch.ops import generator_kernel as gk
from ofdmgan_tpu_torch.utils.kernel_checks import assert_forward_close

SRC = Path(gk.__file__).resolve().parent.parent / "csrc" / "generator_forward.cu"
HEADER = Path(__file__).resolve().parent / "cuda_emulation.h"
SMS = 1   # an emulated card of one SM, so batches past a few blocks loop


def _emulation_source() -> str:
    s = SRC.read_text().replace("#include <cuda_runtime.h>", f'#include "{HEADER}"')
    # kernel<<<grid, block, smem, stream>>>(args) -> emu_launch(kernel, grid, block, smem, args)
    s, n = re.subn(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*[^>]+>>>\((\w+)\)",
                   r"emu_launch(\1, \2, \3, \4, \5)", s)
    assert n == 1, "the source launches its kernel once with <<<...>>>"
    return s


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("generator_forward_emulated")
    (d / "generator_forward.cpp").write_text(_emulation_source())
    out = d / "libgenerator_forward_emulated.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread",
                    "-Wno-unknown-pragmas", "-o", str(out), str(d / "generator_forward.cpp")],
                   check=True, capture_output=True)
    return gk.bind_forward(ctypes.CDLL(str(out)))


def _generator(seed):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = MiniGenerator()
        with torch.no_grad():   # biases off zero, weights off their initial scale
            for p in g.parameters():
                p.add_(0.1 * torch.randn_like(p))
    return g


def _run(lib, g, noisy):
    """The emulated kernel's fake, as ``generator_forward``'s."""
    b = noisy.shape[0]
    out = torch.full((b, 16, 2), float("nan"))
    params = [p.detach().contiguous() for p in g.parameters()]
    err = lib.ofdm_generator_forward_launch(
        b, lib.ofdm_generator_forward_blocks(b, SMS), g.leaky_slope,
        noisy.data_ptr(), *noisy.stride(), *(p.data_ptr() for p in params), out.data_ptr(),
        None)
    assert err == 0
    return out


def _frames(b, seed, layout):
    gen = torch.Generator().manual_seed(seed)
    if layout == "contiguous":
        return torch.randn(b, 16, 2, generator=gen)
    if layout == "channels_first":   # [B, 2, 16] seen as [B, 16, 2]
        return torch.randn(b, 2, 16, generator=gen).transpose(1, 2)
    return torch.randn(2 * b, 16, 2, generator=gen)[::2]   # every other frame


@pytest.mark.parametrize("layout", ["contiguous", "channels_first", "every_other"])
@pytest.mark.parametrize("b", [1, 5, 127, 128, 129, 255, 600, 1000])
def test_emulated_kernel_matches_plain_version(lib, b, layout):
    """127 and 129 frames leave a group of 128 threads one short and one
    past; 600 and 1000 on one SM loop over the batch, the last group
    ragged."""
    g = _generator(b)
    noisy = _frames(b, b + 1, layout)
    got = _run(lib, g, noisy)
    assert got.is_contiguous()
    assert_forward_close(got, gk.generator_forward_plain(g, noisy))


# slices of a 300-frame batch: the whole again, its first half, one frame
# inside a group and the ragged last group
SLICES = {"again": slice(None), "first_half": slice(0, 150), "one_frame": slice(7, 8),
          "last_group": slice(256, 300)}


@pytest.mark.parametrize("part", sorted(SLICES))
def test_emulated_frames_do_not_depend_on_their_batch(lib, part):
    """A frame's fake is the same bits alone or in a slice of a batch as in
    the whole batch."""
    g = _generator(3)
    noisy = _frames(300, 4, "contiguous")
    whole = _run(lib, g, noisy)
    assert torch.equal(whole[SLICES[part]], _run(lib, g, noisy[SLICES[part]]))


def test_blocks_and_refusals(lib):
    """Blocks cover the batch up to the card's cap; a batch or grid of 0 is
    refused."""
    cap = lib.ofdm_generator_forward_blocks(1 << 30, SMS)
    assert lib.ofdm_generator_forward_blocks(1, SMS) == 1
    assert lib.ofdm_generator_forward_blocks(129, 132) == 2
    assert lib.ofdm_generator_forward_blocks(1 << 20, SMS) == cap
    for b, nblocks in ((0, 1), (64, 0)):
        assert lib.ofdm_generator_forward_launch(b, nblocks, 0.2, *([None] + [0] * 3),
                                                 *[None] * 10) != 0
