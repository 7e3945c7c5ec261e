"""Per cent of the traced time in which the engine held an active request
and no operation ran on the device."""


def read(run):
    prof = run.profile
    if not prof or prof["active_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_in_active_s"] / prof["active_s"])
