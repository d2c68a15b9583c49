"""K3's share of its roofline: the least time the profiled weight steps'
work needs (``roofline/k3.py``) over K3's device time, %."""

from benchmark.roofline import k3

KERNEL = "fused_resample"


def read(t):
    w = t.work
    launches = t.counters.get("bssm_fused_resample", 0)
    device_s = t.kernel_s(KERNEL)
    if not launches or device_s <= 0:
        return None
    c = w["chains"]
    one, _ = k3.weight_step(c, w["lanes"], w["state_cols"],
                            c * w["particles"])
    return 100.0 * one * launches / device_s
