"""Host memory: the peak over the window of the run's process's resident
set, less the bytes of the benchmark's own output buffers, in GiB
(portbench/memory.py says why it is not the proportional set size)."""


def read(ctx):
    if not ctx.peak_rss_bytes:
        return None
    return (ctx.peak_rss_bytes - ctx.sink_bytes) / 2.0 ** 30
