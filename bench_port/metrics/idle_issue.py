"""Share of the traced window in which the device idled while the scan
thread replied to a request or dispatched the next (``scan.reply``,
``scan.dispatch``, the port's spans; ``program_spans.idle_split``)."""

from bench_port.program_spans import idle_share


def read(run):
    return idle_share(run, ("scan.reply", "scan.dispatch"))
