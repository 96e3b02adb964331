"""K2's share of its roofline in phase: the least time the window's K2-fwd
and K2-bwd WORDS work needs on the chip (roofline.py's counts) over their
device time in the trace. A totals-only caller needs no WORDS half, which
the count includes as the launches run it."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    return roofline.share(run.work.get("k2", {}).get("bound_s", 0.0),
                          run.trace.seconds_of("k2_fwd_kernel",
                                               "k2_bwd_kernel"))
