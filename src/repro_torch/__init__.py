"""PyTorch and CUDA port of the DFR train-while-serve system, its offline
training recipe, and the LM families that serve, prefill and train.

Mirrors the layout of the JAX package ``repro`` (configs/, core/, data/,
kernels/, launch/, models/, optim/, runtime/) and imports nothing from
it.  Entry
points run on the CUDA device unless the caller passes ``device="cpu"``;
the hand-written Hopper kernels live in ``kernels/csrc`` and build with
``nvcc`` at first use.
"""
