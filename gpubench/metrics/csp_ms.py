"""Mean over the window's steps of the program's ``tick.split`` +
``tick.merge`` spans (laying out the CSP batch and gathering it back per
request), in ms, from each step's ``TickEvents``."""
from gpubench import spans


def read(run):
    return spans.csp_ms([t.events for t in run.window_ticks])
