"""The share of the lane-slots K1's blocks issued for a callback's loop
that did a lane's work, %: 100 x the program's ``sweep.loop_iters`` (the
lanes' own iterations) over ``sweep.loop_slots`` (each block's largest
iteration count times its lanes), the median over the window's
unprofiled ``sample_chains`` calls. Divergence between the lanes of a
chain sets what is left. A program without those counters gives no
number."""

from benchmark.lib import program_spans as ps


def _share(call):
    c = call["counters"]
    iters, slots = c.get("sweep.loop_iters", 0), c.get("sweep.loop_slots", 0)
    return 100.0 * iters / slots if slots else None


def read(t):
    return ps.median_of("sample_chains", _share)
