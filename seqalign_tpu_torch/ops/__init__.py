"""The port's DP engines: plain PyTorch (swa_torch) and the CUDA kernel
(swa_cuda)."""
