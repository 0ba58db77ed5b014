"""setup_s (s): the start of the process to the start of the window:
weights, cluster, seed, warm-up (and, in a checkout's first run, the
kernel build)."""


def read(run):
    return run.setup_s
