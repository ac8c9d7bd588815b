"""PyTorch/CUDA port of the SplitFT reproduction.

The JAX package ``repro`` is the reference; this package computes the
same functions in PyTorch and runs the TPU kernels' work in CUDA kernels
written for Hopper (``csrc/``).  It never imports ``jax`` or ``repro``.

Entry points (``Model``, ``ServingEngine``, ``launch/serve.py``) run on
the card unless the caller asks for the CPU; see ``repro_torch.device``.
"""
