"""Seconds of the program's span `banded.device` (a pack's kernels from the
first launch to the end of the words' read-back), summed over calls and
threads, per Mb of regions done; None where the program records no such
span."""


def read(run):
    s = run.profile.get("spans", {}).get("banded.device")
    if s is None or run.kb <= 0:
        return None
    return s["total_s"] / (run.kb / 1000.0)
