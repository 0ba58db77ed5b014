"""staging_copy_s.coldstart (s): device seconds of the profiler's
``Memcpy DtoH`` and ``Memcpy HtoD`` events inside each traced fork (the
wire payload staged through host memory), averaged over the traced
forks."""


def read(run):
    forks = [row["fork"] for row in run.trace.get("invocations", {}).values()
             if "fork" in row and row["fork"].get("all")]
    if not forks:
        return None
    return sum(f.get("memcpy_dtoh", 0.0) + f.get("memcpy_htod", 0.0)
               for f in forks) / len(forks)
