"""Share of the profiled stretch's wall time in which no operation ran on
the device: 1 - (union of the device's operation intervals) / wall, %."""


def read(t):
    return t.idle_share()
