"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(port of ``src/repro/kernels/``). Importing this package builds nothing."""
