"""The writer (pipeline/mesher.py::write, io/ply.py): ms a job of
`write.time`, the mesh written into the benchmark's memory sink."""


def read(ctx):
    return ctx.per_job_ms("write.time")
