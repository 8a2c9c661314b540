"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version beside it (``ref.py`` holds the oracles they are built on)."""
