"""The whole train step's share of the H100's bf16 peak: the step's model
FLOPs (forward, data gradients above the first trainable layer, weight
gradients of the trainable layers; h100bench/work/flops.py) over the
seconds a step takes (the mean of the traced window's steps before the
profile, which slows the steps it covers) times 989 TFLOP/s."""

from h100bench.work import flops, kernels


def read(ctx):
    st = ctx.get("stretch")
    if ctx["entry"] != "train" or st is None:
        return None
    mix = ctx["mix"]
    f = flops.count(ctx["model"], mix["batch"], mix["canvas"],
                    mix["sampling"])["train"]
    return 100.0 * f / (ctx["record"]["batch_s"] * kernels.PEAK_BF16)
