"""Terminal progress UI of the CLIs.

Counterpart of ``update_progress`` / ``update_stdout`` in
:mod:`warpedganspace_tpu.utils.aux` (reference lib/aux.py:107-132).
"""
from __future__ import annotations

import sys


def update_progress(msg: str, total: int, progress: int) -> None:
    """One-line block progress bar (reference lib/aux.py:107-120)."""
    bar_length, status = 20, ""
    frac = float(progress) / float(total)
    if frac >= 1.0:
        frac, status = 1, "\r\n"
    block = int(round(bar_length * frac))
    text = "\r{}{} {:.0f}% {}".format(
        msg, "█" * block + "░" * (bar_length - block), round(frac * 100, 0), status
    )
    sys.stdout.write(text)
    sys.stdout.flush()


def update_stdout(num_lines: int) -> None:
    """Move the cursor up and erase the given number of lines (lib/aux.py:122-132)."""
    for _ in range(num_lines):
        print("\x1b[1A" + "\x1b[1A")
