"""Seconds of the program's span `phase.sv_score` (the SV-length allele
and read substring pairs: their k-mer anchors, items and the banded
seam's totals), summed over calls and threads, per Mb of regions done;
None where the program records no such span."""


def read(run):
    s = run.profile.get("spans", {}).get("phase.sv_score")
    if s is None or run.kb <= 0:
        return None
    return s["total_s"] / (run.kb / 1000.0)
