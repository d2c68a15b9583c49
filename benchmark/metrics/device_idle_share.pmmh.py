"""Share of one whole profiled ``pmmh()`` call's wall time in which no
operation ran on the device: 1 - (union of the device's operation
intervals) / wall, %."""


def read(t):
    return t.idle_share()
