"""Hand-written CUDA kernels for the port, each beside its plain torch
version.

``finish_batch`` holds the batched cost-kernel arithmetic behind the
``torch`` executor backend (:mod:`repro_torch.core.engine`).  Sources live
in ``repro_torch/csrc/`` and are built on first use by
:mod:`repro_torch.kernels._build`; importing this package builds nothing.
"""
