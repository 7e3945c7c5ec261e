"""Per cent of the request-steps spent on the window's requests that went to
requests which then missed their deadline or were dropped after admission."""


def read(run):
    steps = [(s.request.steps_done, s.met) for s in run.counted]
    total = sum(n for n, _ in steps)
    return 100.0 * sum(n for n, met in steps if not met) / total if total else None
