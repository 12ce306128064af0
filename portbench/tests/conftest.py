"""Pytest settings of the benchmark's own tests (python -m pytest portbench/tests)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where torch.cuda.is_available() is false")
