"""The mesher's prepare (pipeline/mesher.py's OOCMesher.prepare, on the
prepare pool of pipeline/streamer.py's consume_threaded): ms a block of
`mesher.prepareTime`, the wall time of its `prepare` actions, several
blocks at once on the pool's threads. None where the program has no
prepare pool."""


def read(ctx):
    return ctx.per_block_ms("mesher.prepareTime")
