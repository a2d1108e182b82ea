"""Race-free builds of the port's shared libraries (utils/native_build.py).

Six processes start at once on an empty build directory (given through
MLSGPU_TORCH_BUILD_DIR, never the package's own `_build/`):
- each builds and loads the native host library and decodes the same packed
  readback image natively: all six load it and agree with the numpy decoder
  bit for bit;
- each asks `mls_cuda.build` for the kernel library through a stub compiler
  that writes its output slowly in two halves: the stub runs once, on both
  kernel sources, and every process finds the whole file.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import torch

from mlsgpu_tpu_torch.ops import block, marching, weld

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCS = 6

_BARRIER = """
import os, sys, time
work = sys.argv[1]
open(os.path.join(work, "ready." + sys.argv[2]), "w").close()
while not os.path.exists(os.path.join(work, "go")):
    time.sleep(0.005)
"""

_NATIVE = _BARRIER + """
import numpy as np
from mlsgpu_tpu_torch import _native as nat
assert nat.get_lib() is not None, nat.last_error
d = np.load(os.path.join(work, "image.npz"))
v, t, k = nat.unpack_readback(d["img"], int(d["ni"]), int(d["nv"]),
                              int(d["fe"]), str(d["mode"]),
                              int(d["vw"]), d["origin"])
np.savez(os.path.join(work, "out." + sys.argv[2] + ".npz"), v=v, t=t, k=k)
"""

_KERNEL = _BARRIER + """
from mlsgpu_tpu_torch.ops import mls_cuda
path = mls_cuda.build(compiler=[sys.executable, os.path.join(work, "stub.py")])
with open(path, "rb") as f:
    print(len(f.read()))
"""

_STUB = """
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(LOG, "a") as log:
    log.write(" ".join([out] + [a for a in sys.argv if a.endswith(".cu")])
              + "\\n")
with open(out, "wb") as f:
    f.write(b"x" * 50000)
    f.flush()
    time.sleep(0.5)
    f.write(b"y" * 50000)
"""


def _race(tmp_path, code):
    """Start PROCS copies of `code` together (a file barrier) with an empty
    build directory; returns their completed processes."""
    work = tmp_path / "work"
    work.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MLSGPU_TORCH_BUILD_DIR=str(tmp_path / "build"))
    env.pop("MLSGPU_TPU_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(work), str(i)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(PROCS)]
    deadline = time.monotonic() + 240
    while (len(list(work.glob("ready.*"))) < PROCS
           and time.monotonic() < deadline
           and all(p.poll() is None for p in procs)):
        time.sleep(0.01)
    (work / "go").touch()
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        out.append((p.returncode, stdout, stderr))
    assert not list((tmp_path / "build").glob("*.tmp"))
    return out


def _packed_image():
    """A packed readback image of a small open sphere (u21x3 indices)."""
    g = np.arange(24, dtype=np.float64)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    field = (np.sqrt((xx - 20.0) ** 2 + (yy - 11.5) ** 2 + (zz - 11.5) ** 2)
             - 8.0).astype(np.float32)
    region, origin = (23, 23, 23), (3, 5, 7)
    m = marching.generate_mesh(torch.as_tensor(field), region, origin)
    w = weld.weld(m.vertices, m.key_hi, m.key_lo, m.triangles)
    fmt = block.PackFormat("u21x3", 3, 6)
    img = block.pack_readback(w, origin, fmt).numpy().view(np.uint32)
    return img, w, fmt, np.asarray(origin, np.int64)


def test_native_library_six_processes_at_once(tmp_path):
    img, w, fmt, origin = _packed_image()
    ni, nv, fe = w.num_indices, w.num_vertices, w.first_external
    assert 0 < fe < nv
    (tmp_path / "work").mkdir()
    np.savez(tmp_path / "work" / "image.npz", img=img, ni=ni, nv=nv, fe=fe,
             mode=fmt.index_mode, vw=fmt.vertex_words, origin=origin)
    results = _race(tmp_path, _NATIVE)
    for rc, _, err in results:
        assert rc == 0, err
    rv, rt, rk = block.unpack_readback(img, ni, nv, fe, fmt, origin)
    rv = rv + origin.astype(np.float32)
    for i in range(PROCS):
        d = np.load(tmp_path / "work" / f"out.{i}.npz")
        np.testing.assert_array_equal(d["v"].view(np.uint32),
                                      rv.view(np.uint32))
        np.testing.assert_array_equal(d["t"], rt)
        np.testing.assert_array_equal(d["k"], rk)
    assert (tmp_path / "build" / "libmlsnative.so").exists()


def test_kernel_build_lock_six_processes_at_once(tmp_path):
    (tmp_path / "work").mkdir()
    log = tmp_path / "work" / "stub.log"
    (tmp_path / "work" / "stub.py").write_text(
        textwrap.dedent(_STUB).replace("LOG", repr(str(log))))
    results = _race(tmp_path, _KERNEL)
    for rc, out, err in results:
        assert rc == 0, err
        assert int(out.split()[-1]) == 100000     # never a partial file
    lines = log.read_text().splitlines()
    assert len(lines) == 1                         # built once, under lock
    assert [os.path.basename(a) for a in lines[0].split()[1:]] == [
        "mls_field.cu", "seam_moments.cu"]         # one call, both sources
    assert (tmp_path / "build" / "libmls_field.so").stat().st_size == 100000
