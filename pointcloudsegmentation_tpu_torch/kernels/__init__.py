"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (used for CPU tensors and as the reference on the card)."""
