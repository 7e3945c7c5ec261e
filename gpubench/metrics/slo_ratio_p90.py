"""90th percentile of latency over SLO budget, over the window's completed requests."""
from gpubench import reduce


def read(run):
    return reduce.ratio_p90(run)
