"""Host milliseconds inside the sampler call, which returns once its work is
queued, per denoising step: the harness's own span around each batch's
call in the unprofiled window, over the batch's steps."""


def read(run):
    rec = run["record"]
    if not rec.get("enqueue_s"):
        return None
    return 1e3 * sum(rec["enqueue_s"]) / (len(rec["enqueue_s"]) * rec["steps"])
