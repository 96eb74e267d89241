"""generator_ms_per_frame.render: the kernel time launched inside the port's
``wgs.render.generator`` spans (the tails' weight preparation nested in them
included) in the traced render window, per frame delivered
(``benchmark/spans.py``)."""
from benchmark.spans import read as read_span


def read(view):
    return read_span(view, "generator_ms_per_frame")
