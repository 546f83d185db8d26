"""The ``gpu`` marker, for the benchmark's tests run on their own."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA GPU; skips with a reason where there is none")
