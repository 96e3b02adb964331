"""K3's share of its roofline: the least time the window's K3-fwd and
K3-bwd work needs on the chip (roofline.py's counts, without the
backward's recompute) over their device time in the trace."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    return roofline.share(run.work.get("k3", {}).get("bound_s", 0.0),
                          run.trace.seconds_of("k3_fwd_kernel",
                                               "k3_bwd_kernel"))
