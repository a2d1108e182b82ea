"""The streamer's mesh window (pipeline/streamer.py::MeshWindow): the
peak of `mem.meshWindow` over the window, MiB."""


def read(ctx):
    v = ctx.peak("mem.meshWindow")
    return None if v is None else v / 2.0 ** 20
