"""Fixtures of the benchmark's tests."""

import shutil
import tempfile

import pytest


@pytest.fixture
def tmp_env():
    """TMPDIR, HOME and XDG_CACHE_HOME of the run's own, as the driver
    gives each side."""
    base = tempfile.mkdtemp(prefix="pb-", dir="/tmp")
    env = {}
    for key in ("TMPDIR", "HOME", "XDG_CACHE_HOME"):
        env[key] = tempfile.mkdtemp(prefix=key[0].lower(), dir=base)
    yield env
    shutil.rmtree(base, ignore_errors=True)
