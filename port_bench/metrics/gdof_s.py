"""gdof_s: giga input DOFs a second over the whole window, the upstream
suite's counting (benchmark05.cc:1407-1419: nelmt * nm0 * nm1 * nm2 a
call) times the calls completed, over the window's host-clock seconds from
the first enqueue to the final synchronize."""


def read(run):
    return 1e-9 * run.op.dof(run.config) * run.calls / run.window_s
