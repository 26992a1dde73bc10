"""The benchmark of the PyTorch and CUDA port (``hawq_tpu_torch``); see
README.md."""
