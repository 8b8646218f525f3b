"""Peak device memory allocated during the window (reset when it opens),
in 10^9 bytes; nothing when no card was used."""


def read(run):
    return None if run.serve_mem_bytes is None else run.serve_mem_bytes / 1e9
