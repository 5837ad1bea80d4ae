"""K2, K1's backward pair (csrc/deform_gather_contract_bwd_{data,weight}.cu)
against its roofline in a train step: the bwd-data and bwd-weight bounds
of K1's calls over the device time of the backward kernels (NAMES)
without the grouped template's marks (GROUPED), as the chip smoke
test's profile tells them apart."""

from h100bench.work import kernels, roofline, sites

NAMES = ("bwd_data_kernel", "bwd_weight_kernel")
GROUPED = ("true>", "(bool)1>", "gdw_bf16")


def is_kernel(name):
    return (any(k in name for k in NAMES)
            and not any(g in name for g in GROUPED))


def read(ctx):
    return roofline.share(ctx, sites.k1_calls,
                          [kernels.work_bwd_data, kernels.work_bwd_weight],
                          is_kernel, entry="train")
