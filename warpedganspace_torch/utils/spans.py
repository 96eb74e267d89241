"""Named host spans of the port, for ``torch.profiler``.

``with span("wgs.<stage>.<part>"):`` marks a stretch of the host's work in
whatever profile records the calling thread, on the profiler's own clock,
beside the device events that the profile's CUDA activity records. A reader
of the trace can then put each kernel and copy down to the innermost span
that was open on the thread that launched it (its runtime launch event
carries the kernel's correlation id) and each idle stretch of the device
down to what the host was doing.

The span is recorded as an operator range (``RecordFunctionFast``), not as a
user annotation (``torch.profiler.record_function``): the profiler mirrors
every user annotation that holds kernels as a range of the same name among
the device events, which a reader summing device events would count as
device work. With no profiler running, entering and leaving one costs about
a microsecond of the host's time where ``record_function`` costs ten or more
(``PERF.md``), so spans stay in the render stream's per-batch path.
"""
from torch._C._profiler import _RecordFunctionFast as span

__all__ = ["span"]
