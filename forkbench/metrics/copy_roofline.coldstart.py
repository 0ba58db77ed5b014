"""copy_roofline.coldstart (%): the four page-copy kernels' share of
their roofline inside the traced forks: each page they moved
(``dispatch.pages_moved``) read once and written once over 3.35 TB/s,
over their summed device time (kernels named ``bulk_copy`` or
``copy_rows``)."""
from forkbench import roofline


def read(run):
    need = spent = 0.0
    for v in run.ok:
        row = run.trace.get("invocations", {}).get(v.index, {})
        t = row.get("fork", {}).get("copy_kernels", 0.0)
        if v.forked and t > 0:
            need += roofline.copy_bytes(v.pages_fork, run.page_elems) \
                / roofline.PEAK_BYTES
            spent += t
    return 100.0 * need / spent if spent else None
