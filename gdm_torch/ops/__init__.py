"""Hand-written CUDA kernels of the port, each beside its plain torch
version: K1 (cutband) and K2 (resident)."""
