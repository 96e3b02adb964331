"""Seconds of the program's span `poa.augment` (augmenting the POA graph
with each read's posteriors), summed over calls and threads, per Mb of
regions done; None where the program records no such span."""


def read(run):
    s = run.profile.get("spans", {}).get("poa.augment")
    if s is None or run.kb <= 0:
        return None
    return s["total_s"] / (run.kb / 1000.0)
