"""Milliseconds from the detector's post-forward hook to the detections
in host memory (decode, class-wise NMS with its host synchronisations,
the copy), from the benchmark's CUDA events; the median per batch."""


def read(ctx):
    if ctx["entry"] != "detect":
        return None
    return ctx["median"](ctx["record"].get("decode_nms_ms", []))
