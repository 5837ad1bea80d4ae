"""K1 (csrc/deform_gather_contract.cu: the head towers' DCN and the
pyramid refine) against its roofline in the detect entry: the bound of
the calls a batch makes (h100bench/work/sites.py) over the device time
of the kernels ``is_kernel`` takes by name."""

from h100bench.work import kernels, roofline, sites

NAMES = ("dgc_",)


def is_kernel(name):
    return any(k in name for k in NAMES)


def read(ctx):
    return roofline.share(ctx, sites.k1_calls, [kernels.work], is_kernel,
                          entry="detect")
