"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Importing this package builds nothing: the library is compiled and loaded
at the first launch on a CUDA tensor (``kernels/build.py``).
"""
