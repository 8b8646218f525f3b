"""Mean, over the requests answered inside the window, of the time from
``QueryRouter.submit`` to the start of the request's encode call: the
router's and the pipeline's admission wait."""


def read(run):
    waits = [(r.t_encode[0] - r.t_submit) / 1e6 for r in run.completed if r.t_encode]
    return sum(waits) / len(waits) if waits else None
