"""The port's DP engines: plain PyTorch (swa_torch), the CUDA kernels
(swa_cuda) and the scalar NumPy oracle (oracle)."""
