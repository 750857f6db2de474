"""100 % minus the share of the traced sub-window in which a device event
(kernel, copy or fill) ran: the union of their intervals."""
from portbench import harness


def read(run):
    trace = run["trace"]
    if not trace or not trace["device_events"]:
        return None
    return harness.idle_pct(trace)
