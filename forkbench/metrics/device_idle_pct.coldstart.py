"""device_idle_pct.coldstart (%): the share of the traced sub-window in
which no kernel, copy or set ran on the card."""


def read(run):
    t = run.trace
    if not t.get("device_events") or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
