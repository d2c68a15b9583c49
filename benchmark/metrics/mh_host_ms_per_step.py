"""Host milliseconds an MH step spends outside the filter, on the host's
clock over the window's untraced calls: from each call's start, and from
each filter's return, to the next filter call. The end of a call, where
its samples wait for the device, is left out; no profiler runs in these
calls."""


def read(t):
    h = t.work.get("host", {})
    if not h.get("steps"):
        return None
    return h["outside_s"] / h["steps"] * 1e3
