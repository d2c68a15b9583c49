"""Seconds a ``pmmh()`` call spends sampling (the initial filter and the
chunked MH steps), as the call's own ``timings["sampling"]`` reports
them, mean over the window's untraced calls."""


def read(t):
    runs = [x["sampling"] for x in t.work.get("timings", ())
            if "sampling" in x]
    return sum(runs) / len(runs) if runs else None
