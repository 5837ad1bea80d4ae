"""K3 (csrc/grouped_deform_contract.cu: the X-101 backbone's grouped DCN
in c3-c5) against its roofline in the detect entry: the bound of the
calls a batch makes over the device time of the kernels ``is_kernel``
takes by name. None where the configuration has no grouped DCN."""

from h100bench.work import kernels, roofline, sites

NAMES = ("gdc_",)


def is_kernel(name):
    return any(k in name for k in NAMES)


def read(ctx):
    return roofline.share(ctx, sites.k3_calls, [kernels.work], is_kernel,
                          entry="detect")
