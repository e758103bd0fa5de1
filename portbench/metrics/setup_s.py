"""Set-up: process start to the first request (imports, CUDA start, the
seeded weights, the program's trees, the kernel build or load, warm-up)."""


def read(ctx):
    return ctx["setup_s"]
