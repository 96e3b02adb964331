"""Seconds of the program's span `banded.route` (the banded seam's item
geometry and routing), summed over calls and threads, per Mb of regions
done; None where the program records no such span."""


def read(run):
    s = run.profile.get("spans", {}).get("banded.route")
    if s is None or run.kb <= 0:
        return None
    return s["total_s"] / (run.kb / 1000.0)
