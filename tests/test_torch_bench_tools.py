"""The three measuring tools of the port's tools package (bench_d2h,
bench_micro, bench_micro2; tests/test_torch_tools.py has the others) run
small with `--device cpu` and print parseable lines, one JSON object each;
bench_micro2's own copy of the binning key pass gives binning's keys bit
for bit when no part is switched off."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch.tools import bench_d2h, bench_micro, bench_micro2

from tests import oracle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def printed(main, argv):
    """(return code, stdout, stderr) of one tool's main(argv)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_bench_d2h_prints_one_json_line_per_measurement():
    rc, text, _ = printed(bench_d2h.main, [
        "--device", "cpu", "--reps", "2", "--sizes-mb", "0.25", "1",
        "--total-mb", "1"])
    assert rc == 0
    lines = [json.loads(ln) for ln in text.splitlines()]
    assert lines[0]["device"] == "cpu"
    copies = [ln for ln in lines if "transfer_mb" in ln]
    # no pinned memory without a card: the pageable copy alone
    assert [(c["transfer_mb"], c["mode"]) for c in copies] == [
        (0.25, "pageable"), (1.0, "pageable")]
    assert all(c["median_s"] > 0 and c["mb_per_s"] > 0 for c in copies)
    assert sum("scalar_sync_median_s" in ln for ln in lines) == 1
    assert [ln["k_transfers"] for ln in lines if "k_transfers" in ln] == [
        1, 2, 4, 8]


def _timed_lines(text):
    lines = [json.loads(ln) for ln in text.splitlines()]
    timed = {ln["name"]: ln for ln in lines if "median_ms" in ln}
    assert all(ln["median_ms"] > 0 and ln["min_ms"] <= ln["median_ms"]
               for ln in timed.values())
    return lines, timed


MICRO = ["--splats", "20000", "--levels", "4", "--reps", "1", "--device",
         "cpu"]


def test_bench_micro_prints_its_variants():
    rc, text, err = printed(bench_micro.main, MICRO)
    assert rc == 0 and "# device=cpu block:" in err
    lines, timed = _timed_lines(text)
    assert list(timed) == (
        ["bin keys only (no sort)", "bin keys+sort (no gather)",
         "bin full (sort+gather)"]
        + [f"faces chunk={c}" for c in bench_micro.FACE_CHUNKS]
        + [f"faces per-row tree chunk={c}"
           for c in bench_micro.ROW_TREE_CHUNKS]
        + ["skeleton plain"]     # the kernels' lines need a card
        + ["classify cand+gather only", "classify tiled full",
           "classify dense signs only", "classify dense full",
           "march codes full"])
    tiles = next(ln for ln in lines if ln["name"] == "tiles")
    assert 0 < tiles["nonzero"] <= tiles["total"] == 8 ** 3


def test_bench_micro2_prints_its_variants():
    rc, text, _ = printed(bench_micro2.main, MICRO)
    assert rc == 0
    lines, timed = _timed_lines(text)
    assert list(timed) == (
        [f"bin {name}" for name, _ in bench_micro2.KEY_VARIANTS]
        + ["faces chunk=32", "faces chunk=256"]
        + [f"mls 1/{k} of the splats" for k in bench_micro2.THINNING])
    rows = next(ln for ln in lines if ln["name"] == "face rows")
    assert 0 < rows["occupied_rows"] <= rows["face_rows"] == 6 * 9 * 9
    assert 1 <= rows["distinct_tiles_per_row"] <= 4
    per_tile = [timed[f"mls 1/{k} of the splats"]
                ["candidates_per_occupied_tile"] for k in bench_micro2.THINNING]
    assert per_tile == sorted(per_tile, reverse=True) and per_tile[-1] > 0


def test_bench_micro2_full_key_pass_is_binnings():
    """The tool's copy of the key pass with every part on gives
    `binning.splat_keys`' keys bit for bit."""
    from mlsgpu_tpu_torch.ops import binning
    rng = np.random.default_rng(11)
    sp = torch.as_tensor(oracle.sphere_cloud([20, 20, 20], 14.0, 4000, 2.0,
                                             rng))
    va = torch.as_tensor(rng.random(4000) < 0.9)
    want = binning.splat_keys(sp, va, (3, 0, 5), 3, 5)
    got = bench_micro2.keys_variant(sp, va, (3, 0, 5), 3, 5)
    assert torch.equal(got, want)
    assert int((want != binning.INVALID_KEY).sum()) > 4000
