"""Bucketing (pipeline/bucket.py): ms a job of `bucket.time`."""


def read(ctx):
    return ctx.per_job_ms("bucket.time")
