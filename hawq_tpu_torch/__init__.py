"""hawq_tpu_torch — the PyTorch/CUDA port of hawq_tpu for NVIDIA Hopper.

Mirrors the module layout of ``hawq_tpu`` (the JAX reference, which it never
imports): integer configs, quantization numerics, the quantized layers and
ResNet models, QAT training with its checkpoints and the freeze into an
integer model, the host-side fold and input quantization, the integer ResNet
engine (W8A8, W4A4 and mixed precision) and a request batcher.  Every
integer convolution and matmul, in the engine and in the QAT forward alike,
and every activation-range reduction run through hand-written CUDA kernels
for ``sm_90a`` (``hawq_tpu_torch/kernels/csrc``; 4-bit weights
nibble-packed) on a CUDA device, and through their plain PyTorch versions
on the CPU.  Integers, captured featuremaps, calibrated ranges and logits
are bit-identical to ``hawq_tpu``; gradients agree within float32
summation-order tolerance.
"""

__version__ = '0.1.0'
