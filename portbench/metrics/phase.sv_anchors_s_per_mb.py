"""Seconds of the program's span `phase.sv_anchors` (the k-mer anchors of
the SV-length pairs and their banded items, on the host), summed over
calls and threads, per Mb of regions done; None where the program
records no such span."""


def read(run):
    s = run.profile.get("spans", {}).get("phase.sv_anchors")
    if s is None or run.kb <= 0:
        return None
    return s["total_s"] / (run.kb / 1000.0)
