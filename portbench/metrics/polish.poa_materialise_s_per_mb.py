"""Seconds of the program's span `poa.materialise` (building a native POA
graph's node objects from its columns, for the readers that walk them),
summed over calls and threads, per Mb of regions done; None where the
program records no such span."""


def read(run):
    s = run.profile.get("spans", {}).get("poa.materialise")
    if s is None or run.kb <= 0:
        return None
    return s["total_s"] / (run.kb / 1000.0)
