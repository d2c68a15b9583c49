"""Seconds a ``pmmh()`` call spends tuning (the pilot chain and its
variance run), as the call's own ``timings["tuning"]`` reports them (a
phase timer that stops at a device sync), mean over the window's
untraced calls."""


def read(t):
    runs = [x["tuning"] for x in t.work.get("timings", ()) if "tuning" in x]
    return sum(runs) / len(runs) if runs else None
