"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) with their plain
PyTorch versions (``ref``) and the dispatching wrappers (``ops``)."""
