"""Share of the traced window in which no operation (kernel, copy or
memset) ran on the device."""


def read(run):
    if run.trace is None or not run.trace.device_events:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
