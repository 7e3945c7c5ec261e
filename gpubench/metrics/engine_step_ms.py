"""Mean of the engine's own step time (``TickEvents.dt``: host clock between
two device synchronises) over the steps that started in the window."""


def read(run):
    ticks = run.window_ticks
    return 1e3 * sum(t.dt for t in ticks) / len(ticks) if ticks else None
