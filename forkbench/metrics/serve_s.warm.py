"""serve_s.warm (s): the mean time from making the engine and
submitting the request to its answer (synced), over the window's
invocations."""


def read(run):
    t = [v.answer - v.submit for v in run.ok]
    return sum(t) / len(t) if t else None
