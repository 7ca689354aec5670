"""library_s: host seconds of kernels/build.library() in set-up: building
the kernel library where this checkout has none for its sources, else
loading it."""


def read(run):
    return run.library_s
