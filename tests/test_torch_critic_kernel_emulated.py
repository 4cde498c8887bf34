"""The critic-gradient kernel's CUDA source run on the CPU.

``ofdmgan_tpu_torch/csrc/critic_grad.cu`` is built by g++ against
``tests/cuda_emulation.h`` (each CUDA thread an OS thread, barriers for
``__syncwarp`` and ``__syncthreads``, shuffles through a per-warp buffer)
and its C entry point is called on CPU tensors. This holds the kernel's
lane mapping, tile layout, zero rows and empty frame slots against its
plain version, ``critic_grad_packed``, at the card tests' tolerances (rtol
1e-4, atol 1e-4 of each tensor's largest entry: the batch is summed in
another order), in its four forms (float32 or bf16 matmul precision,
float32 or bf16 storage of clean and noisy) and at one and two frames a
warp; a card with two SMs makes the blocks walk the batch in a
grid-stride loop. Skips where g++ is missing.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from ofdmgan_tpu_torch.models import MiniDiscriminator, MiniGenerator
from ofdmgan_tpu_torch.ops import critic_kernel as ck
from ofdmgan_tpu_torch.ops.bf16_dots import round_bf16

SRC = Path(ck.__file__).resolve().parent.parent / "csrc" / "critic_grad.cu"
HEADER = Path(__file__).resolve().parent / "cuda_emulation.h"
SMS = 2   # an emulated card: 2 SMs, so batches past a few warps loop


def _emulation_source() -> str:
    s = SRC.read_text().replace("#include <cuda_bf16.h>", f'#include "{HEADER}"')
    s = s.replace("#include <cuda_runtime.h>", "")
    s = s.replace("extern __shared__ __align__(16) float s_tile[];",
                  "float* s_tile = emu_dyn_smem;")
    # kernel<<<grid, block, smem, stream>>>(args) -> emu_launch(kernel, grid, block, smem, args)
    s, n = re.subn(r"([\w:]+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*[^>]+>>>\((\w+)\)",
                   r"emu_launch(\1, \2, \3, \4, \5)", s)
    assert n == 2, "the source launches its two kernels with <<<...>>>"
    return s


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("critic_emulated")
    (d / "critic_grad.cpp").write_text(_emulation_source())
    out = d / "libcritic_emulated.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread",
                    "-Wno-unknown-pragmas", "-o", str(out), str(d / "critic_grad.cpp")],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(out))
    i, ll, f, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
    so.ofdm_critic_grad_launch.argtypes = ([i, i, i, f, f, i, i] + [ptr, ll, ll, ll] * 3
                                           + [ptr] * 10)
    so.ofdm_critic_grad_blocks.argtypes = [i, i, i]
    so.ofdm_critic_grad_frames_per_warp.argtypes = [i, i]
    return so


def _inputs(b, storage, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        critic, generator = MiniDiscriminator(), MiniGenerator()
    clean = torch.randn(b, 16, 2, generator=g)
    noisy = clean + 0.3 * torch.randn(b, 16, 2, generator=g)
    alpha = torch.rand(b, generator=g)
    with torch.no_grad():
        fake = generator(noisy)   # strided: the generator's output is a transposed view
    if storage:
        clean, noisy = clean.bfloat16(), noisy.bfloat16()
    return critic, clean, fake, noisy, alpha


def _run(lib, critic, clean, fake, noisy, alpha, bf16, frames):
    """The emulated kernel's (gradients, metrics), as ``critic_grad``'s."""
    b = clean.shape[0]
    nblocks = lib.ofdm_critic_grad_blocks(b, SMS, frames)
    scratch = torch.empty(nblocks * 528)
    out = torch.empty(526)
    params = {n: p.detach() for n, p in critic.named_parameters()}
    if bf16:
        params = {n: round_bf16(p) if n.endswith("weight") else p for n, p in params.items()}
    err = lib.ofdm_critic_grad_launch(
        b, nblocks, frames, 0.2, 10.0, int(bf16), ck.STORAGE[clean.dtype],
        clean.data_ptr(), *clean.stride(), fake.data_ptr(), *fake.stride(),
        noisy.data_ptr(), *noisy.stride(), alpha.data_ptr(),
        *(params[n].contiguous().data_ptr() for n, _ in ck.PARAM_SHAPES),
        scratch.data_ptr(), out.data_ptr(), None)
    assert err == 0
    return ck._split(out)


@pytest.mark.parametrize("frames", [1, 2])
@pytest.mark.parametrize("storage", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b", [1, 25, 40])
def test_emulated_kernel_matches_plain_version(lib, b, bf16, storage, frames):
    """25 frames leave a warp's second slot and a block's last warps empty;
    40 at two SMs loop over the batch."""
    critic, clean, fake, noisy, alpha = _inputs(b, storage, b)
    grads, aux = _run(lib, critic, clean, fake, noisy, alpha, bf16, frames)
    ref, ref_aux = ck.critic_grad_packed(critic, clean, fake, noisy, alpha, 10.0, bf16=bf16)
    for name, r in ref.items():
        torch.testing.assert_close(grads[name], r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()) + 1e-7)
    for name, r in ref_aux.items():
        torch.testing.assert_close(aux[name], r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_emulated_storage_form_equals_the_widened_frames(lib, bf16):
    """bf16 clean and noisy are widened where loaded: the float32 kernel's
    result on the widened frames, bit for bit; two calls are equal."""
    critic, clean, fake, noisy, alpha = _inputs(37, True, 5)
    got = _run(lib, critic, clean, fake, noisy, alpha, bf16, 2)
    wide = _run(lib, critic, clean.float(), fake, noisy.float(), alpha, bf16, 2)
    again = _run(lib, critic, clean, fake, noisy, alpha, bf16, 2)
    for a, b, c in zip((*got[0].values(), *got[1].values()), (*wide[0].values(), *wide[1].values()),
                       (*again[0].values(), *again[1].values())):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_frames_per_warp_and_blocks(lib):
    """Two frames a warp from the first batch at which they fill every
    block the card holds (and one frame a warp fills them just below);
    blocks cover the batch's warps up to the card's cap."""
    frames = [lib.ofdm_critic_grad_frames_per_warp(b, SMS) for b in range(1, 4096)]
    first = frames.index(2) + 1
    assert set(frames[:first - 1]) == {1} and set(frames[first - 1:]) == {2}
    cap = lib.ofdm_critic_grad_blocks(1 << 30, SMS, 1)
    assert lib.ofdm_critic_grad_blocks(first, SMS, 2) == cap
    assert lib.ofdm_critic_grad_blocks(first // 2, SMS, 2) < cap
    assert lib.ofdm_critic_grad_blocks(first - 1, SMS, 1) == cap
    assert lib.ofdm_critic_grad_blocks(1, SMS, 1) == lib.ofdm_critic_grad_blocks(1, SMS, 2) == 1
