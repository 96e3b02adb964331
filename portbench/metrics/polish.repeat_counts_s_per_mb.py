"""Chunk-stage seconds of the repeat counts (`repeat_counts`), summed
over chunks and threads, per Mb of regions done."""


def read(run):
    s = run.profile.get("chunk_stage_totals_s", {}).get("repeat_counts")
    return None if s is None or run.kb <= 0 else s / (run.kb / 1000.0)
