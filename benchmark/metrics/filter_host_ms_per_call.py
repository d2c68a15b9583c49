"""Host milliseconds a filter call takes, from the call to its return, on
the host's clock over the window's untraced calls (no profiler runs in
them)."""


def read(t):
    h = t.work.get("host", {})
    if not h.get("filter_calls"):
        return None
    return h["filter_s"] / h["filter_calls"] * 1e3
