"""fork_s.coldstart (s): the mean time from the call to ``invoke`` to the
forked child's materialized tree (synced), over the window's forks: the
cold-start cost (platform and fork, memory and net, the copy kernels)."""


def read(run):
    t = [v.tree_at - v.start for v in run.ok if v.forked]
    return sum(t) / len(t) if t else None
