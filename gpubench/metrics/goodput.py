"""Window requests that met their deadline, per second of window."""


def read(run):
    return sum(s.met for s in run.counted) / run.seconds
