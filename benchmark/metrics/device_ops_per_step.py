"""Device operations (kernels, copies and fills) in the profiled stretch
over its MH steps."""


def read(t):
    steps = t.work.get("steps", 0)
    return t.device_ops / steps if steps and t.device_ops else None
