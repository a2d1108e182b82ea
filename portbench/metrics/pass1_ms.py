"""The streamer (pipeline/streamer.py): ms a job of `pass1.time`, from
the first block loaded to the last one meshed."""


def read(ctx):
    return ctx.per_job_ms("pass1.time")
