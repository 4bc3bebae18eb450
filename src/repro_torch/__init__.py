"""PLAM on PyTorch and CUDA: the port of the ``repro`` JAX package.

The subpackages mirror ``repro`` (``configs``, ``numerics``, ``kernels``,
``core``, ``models``, ``serving``) so each module has a counterpart a
reader can find.  The hot path runs hand-written CUDA kernels for
Hopper (``kernels/csrc``); every kernel keeps a plain PyTorch version
beside it, used for tensors on the CPU.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
This package never imports JAX.
"""
from .device import resolve_device  # noqa: F401
