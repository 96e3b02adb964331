"""Seconds of the program's span `k1.device` (K1 from its launch to the end
of its scores' read-back), summed over calls and threads, per Mb of
regions done; None where the program records no such span."""


def read(run):
    s = run.profile.get("spans", {}).get("k1.device")
    if s is None or run.kb <= 0:
        return None
    return s["total_s"] / (run.kb / 1000.0)
