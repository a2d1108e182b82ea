"""The frozen traffic generator is bitwise the port's bench cloud."""

import numpy as np
import pytest

from mlsgpu_tpu_torch.tools import cloud as port_cloud
from portbench.traffic import generator


@pytest.mark.parametrize("seed", [123, 2147483701])
@pytest.mark.parametrize("n", [1000, 4097])
def test_scan_order_is_the_ports(n, seed, monkeypatch):
    monkeypatch.delenv("BENCH_SHUFFLE", raising=False)
    want, want_sr = port_cloud.make_cloud(n, seed)
    got, got_sr = generator.make_cloud(n, seed)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert got_sr == want_sr


@pytest.mark.parametrize("seed", [123, 2147483701])
def test_shuffled_order_is_the_ports(seed, monkeypatch):
    monkeypatch.setenv("BENCH_SHUFFLE", "1")
    want, _ = port_cloud.make_cloud(2000, seed)
    got, _ = generator.make_cloud(2000, seed, order="shuffled")
    assert got.tobytes() == want.tobytes()


def test_generator_reads_no_environment(monkeypatch):
    monkeypatch.setenv("BENCH_SHUFFLE", "1")
    a, _ = generator.make_cloud(500, 7)
    monkeypatch.delenv("BENCH_SHUFFLE")
    b, _ = generator.make_cloud(500, 7)
    assert a.tobytes() == b.tobytes()


def test_ply_round_trip(tmp_path):
    from mlsgpu_tpu_torch.io.ply import PlyReader
    splats, _ = generator.make_cloud(300, 5)
    path = str(tmp_path / "c.ply")
    generator.write_splats_ply(path, splats)
    back = PlyReader(path).read()
    np.testing.assert_array_equal(back[:, 0:7], splats[:, 0:7])
