"""The share of the profiled window in which no operation ran on the
device, in percent (``torch.profiler``)."""


def read(run):
    if not run.trace:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
