"""Mean relative error, in per cent, of the engine's step-latency prediction
(``scheduler.predict`` on the requests it stepped, asked after the tick)
against the step's measured time, over the window's steps."""


def read(run):
    ticks = [t for t in run.window_ticks if t.dt > 0]
    return 100.0 * sum(abs(t.pred - t.dt) / t.dt for t in ticks) / len(ticks) if ticks else None
