"""Build the JAX package's native library once, before any test runs.

`mlsgpu_tpu/_native` builds `libmlsnative.so` with make on first use,
without a lock and in place. Under pytest-xdist every worker process asks
for it while it collects (tests/test_native_fastpaths.py checks
`available()` at import), so on a fresh tree several workers run make at
once and one may load a half-written library, find it unavailable and
skip the native tests. This hook runs the same make once in the
controlling process, before the workers start; each worker then finds
the library up to date. It changes no test, marker or skip condition, and
does nothing where make or a C++ compiler is missing (the tests then skip
as they always did).
"""

import os
import shutil
import subprocess

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "mlsgpu_tpu", "_native")


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return  # an xdist worker: the controller has built it
    if not shutil.which("make") or not shutil.which(
            os.environ.get("CXX", "g++")):
        return
    try:
        subprocess.run(["make", "-C", _NATIVE, "-s"], capture_output=True,
                       timeout=300, check=False)
    except (OSError, subprocess.SubprocessError):
        pass  # the package's own lazy build still runs
