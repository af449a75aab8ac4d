"""Set-up seconds: from the start of the process's script to the start of
the window (imports, the kernels' build where it runs, inputs from the
seed, the program's state, the warm-up call)."""


def read(run):
    return run.setup_s
