"""Mean ``serve.queued`` span (the port's, ``program_spans``) over the
requests answered inside the window: ``QueryRouter.submit`` entered to the
encode stage taking the request off the admission queue, the program's
twin of ``queue_wait_ms``. A request's span is the last to end by its
encode call's start (one encode thread takes requests in turn)."""

import bisect

from bench_port.program_spans import named


def read(run):
    queued = sorted((s.end, s.end - s.start) for s in named(run, "serve.queued"))
    ends = [q[0] for q in queued]
    waits = []
    for r in run.completed:
        i = bisect.bisect_right(ends, r.t_encode[0]) - 1 if r.t_encode else -1
        if i >= 0:
            waits.append(queued[i][1])
    return sum(waits) / len(waits) / 1e6 if waits else None
