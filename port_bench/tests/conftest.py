"""The benchmark's own tests: on the CPU, at sizes a test run holds.
Tests that need a CUDA card are marked `cuda` and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
