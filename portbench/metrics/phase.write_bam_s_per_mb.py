"""Seconds of the program's span `write_bam` (the pipeline stage that
writes the haplotagged BAM), summed over calls and threads, per Mb of
regions done; None where the program records no such span."""


def read(run):
    s = run.profile.get("spans", {}).get("write_bam")
    if s is None or run.kb <= 0:
        return None
    return s["total_s"] / (run.kb / 1000.0)
