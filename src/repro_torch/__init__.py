"""PyTorch/CUDA port of the Skip2-LoRA system, beside the JAX package ``repro``.

The port mirrors ``repro``'s module layout and names; ``repro`` stays the
reference it is held against. It imports ``torch`` and ``numpy``, never JAX
and nothing of ``repro``. Hand-written Hopper kernels live under
``repro_torch.kernels``; on CPU tensors their plain PyTorch versions run.
"""
