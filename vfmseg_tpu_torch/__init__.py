"""PyTorch + CUDA port of vfmseg_tpu for NVIDIA Hopper.

The JAX package ``vfmseg_tpu`` stays the reference; this package mirrors its
module layout and imports torch, numpy and the standard library only. Its
kernels are CUDA C++ in ``csrc/``, built with nvcc at first use
(``kernels/build.py``); each has a plain PyTorch twin in ``ops/`` that CPU
tensors take.
"""
