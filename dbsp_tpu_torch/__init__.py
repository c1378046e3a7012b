"""dbsp_tpu_torch — the PyTorch/CUDA port of ``dbsp_tpu``.

The same Z-set semantics and operators as the JAX package, on PyTorch
tensors, with the reference's Pallas TPU kernels rewritten by hand in CUDA
C++ for the H100 (``csrc/``, bound in ``zset/cuda_kernels.py``). The port
imports neither JAX nor ``dbsp_tpu``; its outputs equal the reference's on
the same inputs. Entry points run on the card unless the caller asks for
the CPU (``device="cpu"``), where every kernel runs its plain PyTorch
version.
"""
