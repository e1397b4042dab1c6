"""Hopper kernels for the compute hot-spots the paper's resources model.

Each kernel: CUDA C++ in ``csrc/`` (built by :mod:`._build` at first use,
bound with ctypes), a launching wrapper in ``<name>.py``, a plain PyTorch
version and oracle in :mod:`.ref`, and the dispatching public wrapper in
:mod:`.ops`.  Importing this package builds nothing.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
