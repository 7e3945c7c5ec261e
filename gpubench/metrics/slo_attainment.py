"""Per cent of the window's requests that completed by their deadline."""
from gpubench import reduce


def read(run):
    return reduce.attainment(run)
