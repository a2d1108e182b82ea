"""The reader of `mesher_prepare_ms`: ms a block of the mesher's
`mesher.prepareTime`, in every cell; nothing where the program records no
prepare (a program without the prepare pool), never 0."""

from portbench import catalog
from portbench.context import MetricContext


def _ctx(stats):
    return MetricContext(jobs=2, splats=10, window_s=1.0, setup_s=1.0,
                         peak_rss_bytes=1, sink_bytes=0, field_bytes=4,
                         stats=stats)


BLOCKS = {"bucket.count": {"type": "counter", "total": 16}}


def test_reads_ms_a_block_of_prepare_time():
    read = catalog.metric_reader("mesher_prepare_ms")
    stats = dict(BLOCKS, **{"mesher.prepareTime": {
        "type": "variable", "n": 16, "sum": 0.8, "sum2": 0.04}})
    assert read(_ctx(stats)) == 50.0


def test_nothing_to_read_without_a_prepare_pool():
    read = catalog.metric_reader("mesher_prepare_ms")
    assert read(_ctx(dict(BLOCKS))) is None
    assert catalog.read_metrics(
        [{"name": "mesher_prepare_ms", "unit": "ms/block"}],
        _ctx(dict(BLOCKS))) == {}


def test_reported_in_every_cell():
    bench = catalog.benchmark(catalog.HERE + "/..")
    entry, = [m for m in bench["per_layer"]
              if m["name"] == "mesher_prepare_ms"]
    assert (entry["layer"], entry["moves"]) == ("mesher", "msplats_per_s")
    assert "workloads" not in entry
    for cell in catalog.cell_names(bench):
        names = [m["name"] for m in catalog.load_cell(bench, cell).per_layer]
        assert "mesher_prepare_ms" in names
