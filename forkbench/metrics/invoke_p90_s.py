"""invoke_p90_s (s): the 90th percentile of the window's latencies, each
from when it was due to the release (``statistics.quantiles``, n=10,
exclusive)."""
import statistics


def read(run):
    lat = [v.latency for v in run.ok]
    return statistics.quantiles(lat, n=10)[-1] if len(lat) >= 2 else None
