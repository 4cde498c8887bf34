"""ofdmgan_tpu_torch — the PyTorch/CUDA port of ``ofdmgan_tpu``.

The JAX package beside it is the reference. This package keeps its module
names (``signal``, ``models``, ``ops``, ``training``, ``utils``,
``config``) so each counterpart is easy to find, and imports neither JAX nor
PyYAML nor any module of ``ofdmgan_tpu``. The two Pallas TPU kernels of the
training path are hand-written CUDA kernels here (``csrc/``), built with
``nvcc`` into plain-C shared libraries and loaded through ``ctypes``
(``ops/build.py``).

Layout convention: signals are channels-last ``[batch, length, 2]`` (I/Q),
as in the reference. Numerics are full float32 (``device.py``).
"""

__version__ = "0.1.0"
