"""The benchmark of the PyTorch/CUDA port (``repro_torch``): serving cells
on one H100, driven by the data files beside this package
(``BENCHMARK.json`` at the root of the checkout names them)."""
