"""setup_s: host seconds from the start of the run to the start of the
window: imports, the CUDA context, building or loading the kernel library,
the seeded inputs and operators, the operand layout and the warm-up."""


def read(run):
    return run.setup_s
