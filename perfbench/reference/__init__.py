"""The plain reference of the benchmark's cells: NumPy and plain PyTorch.

It imports nothing of the program under test (``ofdmgan_tpu_torch``) and
nothing of JAX, and takes nothing the program made: the benchmark hands it
the weights and the draws it makes itself from the seed, and it works out
the batches, losses, gradients and Adam updates again.

* ``philox``: Philox4x32-10, the uniform and Box-Muller of the datagen
  kernel's stream;
* ``datagen``: the synthetic OFDM batch from those draws;
* ``models``: the mini pair and the full U-Net pair as functions of their
  parameters;
* ``wgan_gp``: the WGAN-GP losses, the outer step and Adam.
"""
