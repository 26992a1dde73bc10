"""hawq_tpu_torch — the PyTorch/CUDA port of hawq_tpu for NVIDIA Hopper.

Mirrors the module layout of ``hawq_tpu`` (the JAX reference, which it never
imports): integer configs, dyadic requant numerics, frozen integer models,
the host-side fold and input quantization, the integer ResNet engine (W8A8,
W4A4 and mixed precision) and a request batcher.  Every integer convolution
and matmul of the engine runs through hand-written CUDA kernels for
``sm_90a`` (``hawq_tpu_torch/kernels/csrc``; 4-bit weights nibble-packed)
on a CUDA device, and through their plain PyTorch versions on the CPU.
Integers, captured featuremaps and logits are bit-identical to
``hawq_tpu``.
"""

__version__ = '0.1.0'
