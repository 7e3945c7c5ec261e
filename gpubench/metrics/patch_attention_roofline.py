"""``patch_attention``'s share of its roofline in the traced stretch."""
from gpubench import reduce

KERNELS = ("patch_attention_kernel", "patch_attention_combine")


def read(run):
    return reduce.roofline_share(run, "attention_calls", "patch_attention", KERNELS)
