"""Seconds of the program's span `banded.host_engine` (the wait, after
the device's packs, on the host wide-band engine's results), summed over
calls and threads, per Mb of regions done; None where the program
records no such span."""


def read(run):
    s = run.profile.get("spans", {}).get("banded.host_engine")
    if s is None or run.kb <= 0:
        return None
    return s["total_s"] / (run.kb / 1000.0)
