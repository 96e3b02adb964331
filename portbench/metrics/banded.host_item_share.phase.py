"""The share of the window's banded items that the host wide-band engine
took, of all the banded seam solved (K2, K3 and the host engine), by the
program's route counters, in percent; None where the seam solved none."""


def read(run):
    c = run.counters
    host = c.get("host_items", 0)
    total = c.get("k2_items", 0) + c.get("k3_items", 0) + host
    return 100.0 * host / total if total else None
