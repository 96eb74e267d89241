"""stream_ms_per_frame.render: the kernel and copy time launched inside the
port's ``wgs.render.to_u8`` and ``wgs.render.d2h`` spans (the uint8
conversion and the device-to-host copy) in the traced render window, per
frame delivered (``benchmark/spans.py``)."""
from benchmark.spans import read as read_span


def read(view):
    return read_span(view, "stream_ms_per_frame")
