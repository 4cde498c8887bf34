"""Image <-> OFDM conversion and the image-backed training datasets.

Counterpart of ``ofdmgan_tpu/signal/image_ofdm.py:33-260``: an image goes to
grayscale, bits (``unpackbits``), QAM symbols, an OFDM signal, padded or
truncated to ``frame_length`` and max-normalised; ``ofdm_to_image`` goes
back. The datasets convert each image once on the host (``load_image`` needs
Pillow, imported only there) and keep the clean frames on the trainer's
device; ``sample_batch(gen, n)`` then draws images, SNRs and the channel on
that device. Each ``sample_batch`` has a ``sample_batch_from_draws`` twin
that takes its random numbers as tensors.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils.iq import complex_to_iq, iq_to_complex, joint_max_normalize
from . import channel as channel_lib
from . import ofdm, qam

EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff")


@dataclasses.dataclass(frozen=True)
class ImageOFDMConfig:
    modulation: str = "QAM16"
    n_subcarriers: int = 64
    cp_length: int = 16
    frame_length: int = 1024


def to_grayscale(image: np.ndarray) -> np.ndarray:
    """RGB -> luma (0.299/0.587/0.114), uint8."""
    if image.ndim == 3:
        image = np.dot(image[..., :3], [0.299, 0.587, 0.114]).astype(np.uint8)
    return image


def image_to_ofdm(image: np.ndarray, cfg: ImageOFDMConfig = ImageOFDMConfig(),
                  normalize: bool = True, truncate: bool = True) -> Tuple[np.ndarray, Dict]:
    """Image -> float32 I/Q frame ``[L, 2]`` and its metadata.
    ``truncate=False`` keeps the whole modulated signal (still zero-padded
    up to ``frame_length``), for the chunk dataset."""
    image = to_grayscale(np.asarray(image))
    pixels = image.flatten().astype(np.uint8)
    bits = np.unpackbits(pixels)

    spec = ofdm.OFDMSpec(cfg.n_subcarriers, cfg.cp_length)
    symbols = qam.modulate(torch.from_numpy(bits), cfg.modulation)
    signal = ofdm.modulate(symbols, spec).numpy()

    if len(signal) < cfg.frame_length:
        signal = np.pad(signal, (0, cfg.frame_length - len(signal)))
    elif truncate:
        signal = signal[:cfg.frame_length]

    iq = complex_to_iq(torch.from_numpy(signal)).numpy().astype(np.float32)
    max_val = float(np.max(np.abs(iq))) if normalize else 1.0
    if normalize and max_val > 0:
        iq = iq / max_val
    metadata = {
        "original_shape": tuple(image.shape),
        "n_pixels": int(pixels.size),
        "n_bits": int(bits.size),
        "n_qam_symbols": int(symbols.shape[-1]),
        "signal_length": int(len(signal)),
        "normalization_factor": max_val if normalize else 1.0,
    }
    return iq, metadata


def ofdm_to_image(iq: np.ndarray, original_shape: Tuple[int, ...],
                  cfg: ImageOFDMConfig = ImageOFDMConfig(),
                  denormalize_factor: float = 1.0) -> np.ndarray:
    """I/Q ``[L, 2]`` -> demodulation -> bits -> uint8 pixels."""
    signal = iq_to_complex(torch.from_numpy(np.asarray(iq * denormalize_factor, np.float32)))
    symbols, _ = ofdm.demodulate(signal, ofdm.OFDMSpec(cfg.n_subcarriers, cfg.cp_length))
    bits = qam.demodulate(symbols, cfg.modulation).numpy()

    n_pixels = int(np.prod(original_shape))
    n_bits = n_pixels * 8
    if bits.size >= n_bits:
        bits = bits[:n_bits]
    else:
        bits = np.concatenate([bits, np.zeros(n_bits - bits.size, int)])
    return np.packbits(bits.astype(np.uint8))[:n_pixels].reshape(original_shape)


def load_image(path: str, max_pixels: int = 4096) -> np.ndarray:
    """A grayscale image as uint8, resized to 64 x 64 when it has more than
    ``max_pixels`` pixels (reference utils/dataset.py:169-182). Needs Pillow."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "L":
        img = img.convert("L")
    if img.size[0] * img.size[1] > max_pixels:
        img = img.resize((64, 64), Image.Resampling.LANCZOS)
    return np.array(img)


def find_images(image_dir: str) -> List[Path]:
    d, files = Path(image_dir), []
    if d.exists():
        for ext in EXTENSIONS:
            files += list(d.glob(f"*{ext}")) + list(d.glob(f"*{ext.upper()}"))
    if not files:
        raise FileNotFoundError(f"no images under {image_dir}")
    return sorted(files)


class ImageOFDMDataset:
    """Image-backed training data (reference OFDMDataset): each image's
    clean frame, and per sample a random image through the channel at a
    random SNR, jointly renormalised."""

    def __init__(self, image_dir: str, frame_length: int = 16, modulation: str = "QPSK",
                 n_subcarriers: int = 8, cp_length: int = 2,
                 snr_range: Tuple[float, float] = (0, 30), channel_type: str = "awgn",
                 samples_per_image: int = 10, device: str | torch.device = "cpu"):
        self.cfg = ImageOFDMConfig(modulation, n_subcarriers, cp_length, frame_length)
        self.snr_range = snr_range
        self.channel = channel_lib.ChannelConfig(channel_type)
        self.samples_per_image = samples_per_image
        self.image_files = find_images(image_dir)
        cleans, factors = [], []
        for p in self.image_files:
            iq, meta = image_to_ofdm(load_image(str(p)), self.cfg)
            cleans.append(iq)
            factors.append(meta["normalization_factor"])
        self._clean = torch.from_numpy(np.stack(cleans)).to(device)            # [n_img, L, 2]
        self._factors = torch.tensor(factors, dtype=torch.float32, device=device)

    def __len__(self) -> int:
        return len(self.image_files) * self.samples_per_image

    def make_draws(self, gen: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
        """``idx`` ``[n]`` images, ``u`` ``[n]`` SNR uniforms, and the
        channel's ``nr``/``ni`` ``[n, L]`` and fading draws."""
        kw = dict(generator=gen, device=gen.device)
        shape = (n, self.cfg.frame_length)
        draws = {"idx": torch.randint(0, self._clean.shape[0], (n,), **kw),
                 "u": torch.rand((n,), dtype=torch.float32, **kw),
                 "nr": torch.randn(shape, dtype=torch.float32, **kw),
                 "ni": torch.randn(shape, dtype=torch.float32, **kw)}
        draws.update(channel_lib.make_draws(gen, self.channel, (n,)))
        return draws

    def sample_batch_from_draws(self, draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The picked images denormalised to the physical signal, through the
        channel at their SNRs, renormalised jointly with the clean frames."""
        idx = draws["idx"]
        clean_iq = self._clean[idx]
        clean_c = iq_to_complex(clean_iq) * self._factors[idx][:, None]
        lo, hi = self.snr_range
        snr = lo + (hi - lo) * draws["u"]
        noisy_c, _ = channel_lib.apply(clean_c, snr, self.channel, draws)
        noisy_iq, clean_out = joint_max_normalize(complex_to_iq(noisy_c), clean_iq)
        return {"noisy": noisy_iq, "clean": clean_out, "snr": snr}

    def sample_batch(self, gen: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
        return self.sample_batch_from_draws(self.make_draws(gen, n))


class ImageOFDMChunkDataset:
    """Chunk-level training data of the image-transmission protocol: every
    aligned ``chunk``-sample piece of each image's whole modulated signal,
    AWGN at the image's own signal power, each chunk normalised by its noisy
    maximum."""

    def __init__(self, image_dir: str, chunk: int = 16, modulation: str = "QAM16",
                 n_subcarriers: int = 64, cp_length: int = 16,
                 snr_range: Tuple[float, float] = (0, 30), samples_per_image: int = 64,
                 pad_to: int = 1024, device: str | torch.device = "cpu"):
        cfg = ImageOFDMConfig(modulation, n_subcarriers, cp_length, frame_length=pad_to)
        self.chunk = chunk
        self.snr_range = snr_range
        self.samples_per_image = samples_per_image
        self.image_files = find_images(image_dir)
        chunks, powers = [], []
        for p in self.image_files:
            iq, _ = image_to_ofdm(load_image(str(p)), cfg, normalize=False, truncate=False)
            iq = np.pad(iq, ((0, (-iq.shape[0]) % chunk), (0, 0)))
            c = iq.reshape(-1, chunk, 2)
            chunks.append(c)
            # the power of the whole transmission, shared by its chunks
            powers.append(np.full(c.shape[0], np.mean(iq ** 2) * 2.0, np.float32))
        self._chunks = torch.from_numpy(np.concatenate(chunks)).to(device)     # [N, chunk, 2]
        self._power = torch.from_numpy(np.concatenate(powers)).to(device)      # [N]

    def __len__(self) -> int:
        return len(self.image_files) * self.samples_per_image

    def make_draws(self, gen: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
        """``idx`` ``[n]`` chunks, ``u`` ``[n]`` SNR uniforms, ``noise``
        ``[n, chunk, 2]`` standard normals."""
        kw = dict(generator=gen, device=gen.device)
        return {"idx": torch.randint(0, self._chunks.shape[0], (n,), **kw),
                "u": torch.rand((n,), dtype=torch.float32, **kw),
                "noise": torch.randn((n, self.chunk, 2), dtype=torch.float32, **kw)}

    def sample_batch_from_draws(self, draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        i = draws["idx"]
        clean = self._chunks[i]
        lo, hi = self.snr_range
        snr = lo + (hi - lo) * draws["u"]
        noise_power = self._power[i] / (10.0 ** (snr / 10.0))
        noisy = clean + torch.sqrt(noise_power / 2.0)[:, None, None] * draws["noise"]
        m = noisy.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-9)
        return {"noisy": noisy / m, "clean": clean / m, "snr": snr}

    def sample_batch(self, gen: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
        return self.sample_batch_from_draws(self.make_draws(gen, n))
