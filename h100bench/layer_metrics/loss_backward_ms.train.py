"""Milliseconds from the detector's post-forward hook to the step's
return with its loss in host memory (assignment, targets, losses,
autograd's backward, clip and SGD), from the benchmark's CUDA events;
the median per step."""


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return ctx["median"](ctx["record"].get("loss_backward_ms", []))
