"""Hand-written CUDA kernels of the port, each beside its plain torch
version: K1 (cutband), K2 (resident), K3 (stencil2) and K4 (stencil3);
and the torch tensor-product operators they are built on (tensor, fast).
"""
