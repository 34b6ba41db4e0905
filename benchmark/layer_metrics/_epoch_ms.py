"""ms per batch epoch as the host sees it: the traced pass's time in
host_batch_epoch (the native float64 epoch and its expansion) and in
run_batch_epoch (a device epoch: symbolic phase, plan and numeric steps,
up to the stats read), over the pass's epochs."""


def read(rec: dict):
    epochs = rec["counters"].get("batch", 0)
    if not epochs:
        return None
    ms = sum(rec["spans"].get(k, (0.0, 0))[0]
             for k in ("host epoch", "device epoch"))
    return ms / epochs
