"""Share of the traced window in which the device idled while the scan
thread waited for an encoded batch (``scan.wait_input``, the port's span;
``program_spans.idle_split``)."""

from bench_port.program_spans import idle_share


def read(run):
    return idle_share(run, ("scan.wait_input",))
