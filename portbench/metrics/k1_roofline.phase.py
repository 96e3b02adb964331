"""K1's share of its roofline: the least time the window's K1 launches
need on the chip (roofline.py's counts) over K1's device time in the trace."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    return roofline.share(run.work.get("k1", {}).get("bound_s", 0.0),
                          run.trace.seconds_of("k1_kernel"))
