"""Device milliseconds of the detector's forward per batch (backbone, FPN,
LSHead), from the CUDA events of the benchmark's pre- and post-forward
hooks; the median over the traced window's batches."""


def read(ctx):
    if ctx["entry"] != "detect":
        return None
    return ctx["median"](ctx["record"].get("forward_ms", []))
