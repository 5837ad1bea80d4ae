"""The whole apis.detect call's share of the H100's bf16 peak: the
forward's model FLOPs per batch, counted on the reference
(h100bench/work/flops.py), over the seconds a batch takes (the mean
of the traced window's batches before the profile, which slows the
batches it covers) times 989 TFLOP/s."""

from h100bench.work import flops, kernels


def read(ctx):
    st = ctx.get("stretch")
    if ctx["entry"] != "detect" or st is None:
        return None
    mix = ctx["mix"]
    f = flops.count(ctx["model"], mix["batch"], mix["canvas"],
                    mix["sampling"])["forward"]
    return 100.0 * f / (ctx["record"]["batch_s"] * kernels.PEAK_BF16)
