"""PyTorch and CUDA port of the DFR train-while-serve system and its offline
training recipe.

Mirrors the layout of the JAX package ``repro`` (core/, kernels/, runtime/,
data/) and imports nothing from it.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``; the hand-written Hopper kernels
live in ``kernels/csrc`` and build with ``nvcc`` at first use.
"""
