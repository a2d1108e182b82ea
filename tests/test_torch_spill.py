"""The port's spill store (mlsgpu_tpu_torch/io/spill.py): reads of any
range, in memory, on disk and across the two, give the appended bytes;
a range inside one in-memory append is a view of it, with no copy."""

import numpy as np
import pytest

from mlsgpu_tpu_torch.io.spill import SpillStore


def chunks(seed=7, sizes=(1000, 37, 4096, 1, 2500, 800)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


@pytest.fixture
def store():
    s = SpillStore("test.spill.", mem_budget=1 << 20)
    yield s
    s.cleanup()


def fill(store, parts):
    offs = [store.append(p) for p in parts]
    return offs, b"".join(parts)


@pytest.mark.parametrize("where", ["memory", "disk", "both"])
def test_every_range_reads_back(where, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    s = SpillStore("test.spill.", mem_budget=1 << 20)
    try:
        parts = chunks()
        if where == "memory":
            _, whole = fill(s, parts)
        elif where == "disk":
            _, whole = fill(s, parts)
            s.flush_all()
        else:
            _, head = fill(s, parts[:3])
            s.flush_all()
            _, tail = fill(s, parts[3:])
            whole = head + tail
        s.freeze()
        rng = np.random.default_rng(3)
        cuts = [(0, len(whole)), (0, 0), (len(whole) - 1, len(whole))]
        cuts += [tuple(sorted(rng.integers(0, len(whole) + 1, 2)))
                 for _ in range(200)]
        for lo, hi in cuts:
            got = s.read(int(lo), int(hi - lo))
            assert bytes(got) == whole[lo:hi], (lo, hi)
            assert got.readonly
        with pytest.raises(EOFError):
            s.read(len(whole) - 4, 5)
    finally:
        s.cleanup()


def test_a_range_inside_one_append_is_not_copied(store):
    parts = chunks()
    offs, _ = fill(store, parts)
    view = store.read(offs[2] + 100, 3000)
    assert view.obj is store._mem[2]
    assert bytes(view) == parts[2][100:3100]
    # across two appends: one copy of its own
    view = store.read(offs[0] + 990, 20)
    assert bytes(view) == parts[0][990:] + parts[1][:10]
    assert not np.shares_memory(np.frombuffer(view, np.uint8),
                                np.frombuffer(parts[0], np.uint8))


def test_records_read_as_the_write_reads_them(store):
    recs = np.arange(4 * 5000, dtype=np.uint32).reshape(5000, 4)
    off = store.append(recs)
    raw = np.frombuffer(store.read(off + 16 * 100, 16 * 300),
                        dtype=np.uint32).reshape(300, 4)
    np.testing.assert_array_equal(raw, recs[100:400])
    assert not raw.flags.writeable


def test_an_array_is_kept_without_a_copy(store):
    recs = np.arange(4 * 1000, dtype=np.uint32).reshape(1000, 4)
    off = store.append(recs)
    view = store.read(off + 16 * 10, 16 * 20)
    assert view.readonly
    assert np.shares_memory(np.frombuffer(view, np.uint32), recs)
    # a strided array is copied into the store
    cols = recs[:, 1:3]
    off = store.append(cols)
    got = np.frombuffer(store.read(off, cols.nbytes), np.uint32)
    np.testing.assert_array_equal(got.reshape(-1, 2), cols)
    assert not np.shares_memory(got, recs)
    # an empty one takes no bytes
    end = store.size()
    assert store.append(np.zeros((0, 4), np.uint32)) == end == store.size()
