"""tail_weights_ms_per_frame.render: the kernel time launched inside the
port's ``wgs.*_tail.weights`` spans (a tail kernel wrapper's weight
preparation) in the traced render window, per frame delivered
(``benchmark/spans.py``)."""
from benchmark.spans import read as read_span


def read(view):
    return read_span(view, "tail_weights_ms_per_frame")
