"""Mean ``encode.upload`` span (the port's, ``program_spans``) of the encode
calls inside the window: the captured encode's stream wait through the copy
into its graph's static input, the host blocked behind the caller's
stream."""

from bench_port.program_spans import in_window, mean_ms


def read(run):
    return mean_ms(in_window(run, "encode.upload"))
