"""Mean, over the requests answered inside the window, of the gap from
the end of the encode call to the start of the search call plus the gap
from the end of the search call to the answer being on the host."""


def read(run):
    gaps = [((r.t_search[0] - r.t_encode[1]) + (r.t_host - r.t_search[1])) / 1e6
            for r in run.completed if r.t_encode and r.t_search]
    return sum(gaps) / len(gaps) if gaps else None
