"""idle_share.<cell kind>: the share of the device window in which no
operation ran on the device (%): 1 - busy_s / window_s."""


def read(run):
    if not run.trace_window_s:
        return None
    return 100.0 * max(0.0, 1.0 - run.busy_s / run.trace_window_s)
