"""PyTorch/CUDA port of the batched-generation path of :mod:`repro`.

The JAX package under ``src/repro`` is the reference; this package imports
none of it (nor JAX) and keeps its own copies of what it needs.  Attention
runs through hand-written Hopper (sm_90a) kernels on CUDA tensors and
through their plain PyTorch versions on CPU tensors.
"""
