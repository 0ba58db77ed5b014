"""invoke_s (s): the window's time over the invocations started in it.
The loop is closed and has one caller, so this is the mean time an
invocation takes from one call to ``invoke`` to the next: the fork, the
answer (device synced), ``release`` and the loop's own work between
calls.  The window closes once the last invocation has returned."""


def read(run):
    return run.window_s / len(run.invocations) if run.invocations else None
