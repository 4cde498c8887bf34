"""Hand-written CUDA kernels of the training path, their plain PyTorch
versions, and the build that compiles them."""
