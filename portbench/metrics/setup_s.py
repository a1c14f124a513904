"""setup_s: from the start of the benchmark's process to the start of the
window: imports, rows and weights, kernel builds and the first rounds."""


def read(ctx):
    return ctx.setup_s
