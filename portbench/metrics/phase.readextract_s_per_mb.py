"""Chunk-stage seconds of read extraction (the program profiler's
`readextract`), summed over chunks and threads, per Mb of regions done."""


def read(run):
    s = run.profile.get("chunk_stage_totals_s", {}).get("readextract")
    return None if s is None or run.kb <= 0 else s / (run.kb / 1000.0)
