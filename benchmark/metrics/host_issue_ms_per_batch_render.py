"""host_issue_ms_per_batch.render: the host's time in the port's
``wgs.render.issue`` and ``wgs.render.deliver`` spans less
``wgs.render.wait``, in the traced render window, per render batch issued
(``benchmark/spans.py``)."""
from benchmark.spans import read as read_span


def read(view):
    return read_span(view, "host_issue_ms_per_batch")
