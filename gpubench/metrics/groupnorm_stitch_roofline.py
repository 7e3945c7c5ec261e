"""``groupnorm_stitch``'s share of its roofline in the traced stretch."""
from gpubench import reduce

KERNELS = ("gn_partials_kernel", "gn_finalise_kernel", "gn_stitch_kernel")


def read(run):
    return reduce.roofline_share(run, "gn_calls", "groupnorm_stitch", KERNELS)
