"""Hand-written CUDA kernels of the port, each beside its plain torch
version: K1 (cutband), K2 (resident), K3 and K3s (stencil2), K4 and K5
(stencil3); and the torch tensor-product operators they are built on
(tensor, fast).
"""
