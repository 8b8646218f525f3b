"""Queries answered inside the window (their ids and scores on the
client's host), over the window's seconds."""


def read(run):
    done = run.completed
    return sum(r.n_queries for r in done) / run.window_s if done else None
