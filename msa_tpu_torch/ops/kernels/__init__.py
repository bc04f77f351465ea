"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. A wrapper takes the plain version only for CPU tensors; a CUDA
tensor always launches the kernel (or raises)."""
