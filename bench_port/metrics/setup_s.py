"""Seconds from the process's start to the window's opening: kernel
builds (first run), weights, corpus, encode, index, warm-up."""


def read(run):
    return run.setup_s
