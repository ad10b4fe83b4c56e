"""setup_s: from the start of the process to the first timed round:
imports, the kernels' build or load, the weights, the checked rounds."""


def read(ctx):
    return ctx["setup_s"]
