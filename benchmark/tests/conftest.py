"""The benchmark's CPU tests: ``python -m pytest benchmark/tests``. A test
that needs a card is marked ``cuda`` and skips inside itself without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
