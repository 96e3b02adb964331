"""Sizes at which a CPU test can run a cell: the program's plain twins
stand in for its kernels there, so contigs of tens of kb."""

PHASE = {"contig_len": 30000, "region_len": 15000, "coverage": 6,
         "read_len": [2000, 5000], "threads": 2}
POLISH = {"contig_len": 6000, "region_len": 3000, "coverage": 8,
          "read_len": [1500, 3000], "chunkSize": 1500, "chunkBoundary": 150,
          "threads": 2}


def overrides(cell: str) -> dict:
    return dict(PHASE if cell.startswith("phase") else POLISH)
