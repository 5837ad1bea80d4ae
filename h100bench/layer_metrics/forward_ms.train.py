"""Device milliseconds of the detector's forward on the bf16 copies inside
the train step, from the CUDA events of the benchmark's pre- and
post-forward hooks; the median per step of the traced window."""


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return ctx["median"](ctx["record"].get("forward_ms", []))
