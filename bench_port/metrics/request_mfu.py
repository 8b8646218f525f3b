"""The chip's peak time that the window's answered queries needed, over
the window: each query's encode FLOPs at the float32 peak plus its
search's int8 operations at the int8 peak (``yardstick.query_need_s``).
Counted per query, so batching requests cannot lift it past the peak."""


def read(run):
    done = run.completed
    if not done or run.trace is None:
        return None
    need = sum(r.n_queries for r in done) * run.query_need_s
    return 100.0 * need / run.window_s
