"""The benchmark of ofdmgan_tpu_torch, the PyTorch/CUDA port (see BENCHMARK.json and PERF.md)."""
