"""PyTorch and CUDA port of the DFR train-while-serve system, its offline
training recipe, and the dense decoder-only LM that serves and prefills.

Mirrors the layout of the JAX package ``repro`` (configs/, core/, data/,
kernels/, launch/, models/, runtime/) and imports nothing from it.  Entry
points run on the CUDA device unless the caller passes ``device="cpu"``;
the hand-written Hopper kernels live in ``kernels/csrc`` and build with
``nvcc`` at first use.
"""
