"""Mean host time inside one encode call (the port's captured encode:
copy in, graph replay, copy out), over the window's answered requests."""


def read(run):
    spans = [(r.t_encode[1] - r.t_encode[0]) / 1e6 for r in run.completed if r.t_encode]
    return sum(spans) / len(spans) if spans else None
