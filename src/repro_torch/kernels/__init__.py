"""Hand-written CUDA kernels for the TPU kernels of the reference, each
beside its plain PyTorch version; `ops` is the way in."""
