"""Wrappers of the hand-written CUDA kernels (sources in `csrc/`), and the
sliding band DFT (`sliding_dft`, plain PyTorch)."""
