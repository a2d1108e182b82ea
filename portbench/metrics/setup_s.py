"""Set-up: from the start of the process to the start of the window
(imports, the library loads or builds, the cloud, the warm-up job)."""


def read(ctx):
    return ctx.setup_s
