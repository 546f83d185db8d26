"""PyTorch/CUDA port of the Cocco reproduction.

Mirrors the layout of the JAX package (``repro_torch.core.cost`` is the
counterpart of ``repro.core.cost``) and imports nothing of it: the planner's
host code is copied, and the device-resident cost evaluation runs on a torch
device through hand-written CUDA kernels (:mod:`repro_torch.kernels`).
Entry point: ``python -m repro_torch`` (:mod:`repro_torch.api.cli`).
"""
