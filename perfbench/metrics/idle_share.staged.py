"""``idle_share.staged``: the share of the traced window in which no operation ran on
the device, in %, over staged queries."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 and t.busy_s > 0 else None
