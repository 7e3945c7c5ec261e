"""Seconds from the process's start to the load's start: the import, the
kernel library's build or load, weights and inputs drawn on the card, the
engine and its calibration."""


def read(run):
    return run.setup_s
