"""The benchmark's own tests: ``python -m pytest port_bench/tests`` from the
root of the repository (``-m cuda`` for the card's)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where there is none)")
