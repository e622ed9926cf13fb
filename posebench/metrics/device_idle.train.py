"""`device_idle.serve`: share of the traced segment, as %, in which no
kernel or copy ran on the device."""


def read(counters, trace):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
