"""Hand-written CUDA kernels for the port, each beside its plain torch
version.

``finish_batch`` holds the batched cost-kernel arithmetic behind the
``torch`` executor backend (:mod:`repro_torch.core.engine`).  ``rmsnorm``,
``fused_ffn``, ``flash_attention`` and ``mla_decode`` hold the LM kernels
the models call through :mod:`repro_torch.kernels.ops`; ``ref`` holds the
first three's plain torch oracles.  Sources live in ``repro_torch/csrc/`` and are built on first use
by :mod:`repro_torch.kernels._build`; importing this package builds
nothing.  The wrappers are not re-exported here: ``rmsnorm`` names the
kernel's module, the wrapper is ``ops.rmsnorm``.
"""
