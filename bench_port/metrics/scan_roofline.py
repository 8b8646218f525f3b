"""Share of the roofline reached by the search calls of the traced window:
the least time their work needs (the larger of its bytes over HBM
bandwidth and its int8 operations over the int8 peak, each counted from
the shapes, ``indexes/<kind>.need``), summed, over the device time of
their kernels, summed."""

from bench_port.yardstick import least_time_s


def read(run):
    if run.trace is None:
        return None
    need = busy = 0.0
    for r in run.searched():
        ns = run.search_kernel_ns(r)
        if ns is not None:
            need += least_time_s(*run.search_need(r.n_queries))
            busy += ns / 1e9
    return 100.0 * need / busy if busy > 0 else None
