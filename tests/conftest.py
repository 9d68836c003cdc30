# NOTE: no XLA_FLAGS here by design -- smoke tests and benches must see the
# single real CPU device.  Multi-device tests spawn subprocesses that set
# --xla_force_host_platform_device_count themselves (tests/test_distributed.py).
import sys

import numpy as np
import pytest

try:  # the container has no hypothesis wheel; fall back to the local stub
    import hypothesis  # noqa: F401
except ImportError:
    import importlib.util
    from pathlib import Path

    _spec = importlib.util.spec_from_file_location(
        "hypothesis", Path(__file__).parent / "_hypothesis_stub.py")
    _stub = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_stub)
    sys.modules["hypothesis"] = _stub


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def tol():
    """The suite-wide per-dtype tolerance asserter (tests/tolerance.py).

    Usage: ``tol(actual, desired, dtype="bf16", scale=2)``.  Prefer this
    (or a direct ``from tolerance import assert_allclose_dtype``) over
    ad-hoc ``np.testing.assert_allclose`` literals -- the band table is
    owned in ONE place.
    """
    from tolerance import assert_allclose_dtype
    return assert_allclose_dtype


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; skips without one")
