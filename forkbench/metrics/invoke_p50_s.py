"""invoke_p50_s (s): the median latency of the window's invocations, each
from when it was due to the warm container's release, so a stall counts
against every request queued behind it.  Below the knee, with steady
arrivals, a request waits only behind the longest ones: this is mostly
service time."""
import statistics


def read(run):
    lat = [v.latency for v in run.ok]
    return statistics.median(lat) if lat else None
