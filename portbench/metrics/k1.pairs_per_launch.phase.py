"""Pairs a K1 launch scores: the pairs of the launches the window made
over the program's K1 launch counter."""


def read(run):
    n = run.counters.get("k1_launches", 0)
    pairs = run.work.get("k1", {}).get("pairs", 0)
    return pairs / n if n and pairs else None
