"""Mean ``rerank.host`` span (the port's, ``program_spans``) of the search
calls inside the window: the bi-granular search's host part, from the
survivors' ids on the host to the last upload of their rows issued."""

from bench_port.program_spans import in_window, mean_ms


def read(run):
    return mean_ms(in_window(run, "rerank.host"))
