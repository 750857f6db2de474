"""The share of the unprofiled window in which the card sat idle: 100 %
minus the device seconds of one batch (the union of its kernels, copies
and fills in the traced batch) over the seconds a batch took in the
unprofiled window (its batch over its rate). The profiler's own host cost
slows the traced batch's dispatch, so the traced batch's idle share
(``device.busy_s`` over ``device.window_s``) reads above this one where the
host sets the pace; the device seconds it reads do not change."""


def read(run):
    trace, rec = run["trace"], run["record"]
    if not trace or not trace["device_events"] or not rec.get("rate"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] * rec["rate"] / rec["batch"])
