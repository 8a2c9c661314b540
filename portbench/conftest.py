"""pytest settings of the benchmark's own tests: the ``card`` marker.

A test marked ``card`` needs an NVIDIA card and skips, with its reason,
where none is found; it decides inside the test, never at import."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")
