"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``cuda`` marker of the repository's suite."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
                   "torch.cuda.is_available() is false")
