"""PyTorch/CUDA port of commefficient_tpu for NVIDIA Hopper (H100).

The JAX package ``commefficient_tpu`` is the reference and stays
unchanged; this package mirrors its module paths and is held against it
by ``tests/test_torch_*.py``. The port covers the FetchSGD sketch-mode
round with ResNet9 (ROADMAP.md, slice 1): the three TPU kernels on that
path are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, each with
a plain PyTorch version beside its wrapper.
"""
