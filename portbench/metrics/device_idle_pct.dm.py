"""100 % minus the share of the traced batch in which a device event
(kernel, copy or fill) ran: the union of their intervals. The card sets
the DM's pace, so the profiler's host cost leaves this share as it is."""
from portbench import harness


def read(run):
    trace = run["trace"]
    if not trace or not trace["device_events"]:
        return None
    return harness.idle_pct(trace)
