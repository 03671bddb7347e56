"""`device.idle_pct`: the share of the traced window in which no kernel, copy
or set ran on the device (one minus the union of their intervals)."""


def read(r):
    if r.busy_s is None:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
