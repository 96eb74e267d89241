"""device_idle_pct.render: the share of the traced render window in which the
card ran no kernel and no copy, as the mean over the cards used."""


def read(view):
    if "frames" not in view.work:
        return None
    return sum(100.0 * (1.0 - t.busy_s() / t.window_s) for t in view.traces) / len(view.traces)
