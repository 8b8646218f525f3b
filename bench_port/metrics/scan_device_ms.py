"""Mean, over the search calls made inside the traced window, of the
device time of the kernels each call launched (attributed by launching
thread and time, not by kernel name)."""


def read(run):
    if run.trace is None:
        return None
    ns = [run.search_kernel_ns(r) for r in run.searched()]
    ns = [t for t in ns if t is not None]
    return sum(ns) / len(ns) / 1e6 if ns else None
