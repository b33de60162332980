"""The benchmark's tests: CPU tests at tiny sizes, and tests marked ``card``
that need a CUDA card and decide inside the test whether one is there."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
