"""PyTorch/CUDA port of the H-FA reproduction (``repro``), slice by slice.

Mirrors the reference package's layout - ``core``, ``kernels``,
``models``, ``configs``, ``serving``, ``launch`` - so each module has a
counterpart.  Imports torch, numpy and the standard library only; the
CUDA kernels (``csrc/``) are built with nvcc at first use on a machine
with the card.
"""
