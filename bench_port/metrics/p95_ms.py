"""95th percentile of the latency of every request answered inside the
window: from the client's ``QueryRouter.submit`` until its ids and scores
are on the host."""

from bench_port.cell import percentile


def read(run):
    done = run.completed
    return percentile([(r.t_host - r.t_submit) / 1e6 for r in done], 95) if done else None
