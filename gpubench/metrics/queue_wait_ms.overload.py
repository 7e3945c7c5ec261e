"""Mean over the window's admitted requests of the wait from the due time to
Algorithm 1's admission (``Request.admitted``, the tick's ``now``), in ms."""
from gpubench import spans


def read(run):
    return spans.queue_wait_ms(run)
