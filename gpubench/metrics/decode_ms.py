"""Mean over the window's completed requests of their ``tick.decode`` span
(``Request.decode_span``: postprocess, VAE decode and the copy to the host),
in ms."""
from gpubench import spans


def read(run):
    return spans.decode_ms(run)
