"""Indexed FASTA access (faidx equivalent; htsIntegration.c:1993-2018)."""

from __future__ import annotations

import os


class FastaIndex:
    """Reads a .fai index: name, length, offset, linebases, linewidth."""

    def __init__(self, fasta_path: str):
        self.path = fasta_path
        fai = fasta_path + ".fai"
        self.entries = {}
        self.names = []
        if os.path.exists(fai):
            with open(fai) as fh:
                for line in fh:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) < 5:
                        continue
                    name = parts[0]
                    self.entries[name] = tuple(int(x) for x in parts[1:5])
                    self.names.append(name)
        else:
            self._build_index()

    def _build_index(self):
        """Scan the FASTA and build the index in memory (like samtools faidx)."""
        with open(self.path, "rb") as fh:
            name = None
            length = 0
            offset = 0
            linebases = 0
            linewidth = 0
            pos = 0
            for line in fh:
                if line.startswith(b">"):
                    if name is not None:
                        self.entries[name] = (length, offset, linebases, linewidth)
                        self.names.append(name)
                    name = line[1:].split()[0].decode("ascii")
                    length = 0
                    offset = pos + len(line)
                    linebases = 0
                    linewidth = 0
                else:
                    stripped = line.rstrip(b"\r\n")
                    if linebases == 0:
                        linebases = len(stripped)
                        linewidth = len(line)
                    length += len(stripped)
                pos += len(line)
            if name is not None:
                self.entries[name] = (length, offset, linebases, linewidth)
                self.names.append(name)

    def length(self, contig: str) -> int:
        return self.entries[contig][0]

    def fetch(self, contig: str, start: int, end: int) -> str:
        """0-based, end-exclusive fetch."""
        length, offset, linebases, linewidth = self.entries[contig]
        start = max(0, start)
        end = min(end, length)
        if start >= end:
            return ""
        fb_start = offset + (start // linebases) * linewidth + start % linebases
        fb_end = offset + ((end - 1) // linebases) * linewidth + (end - 1) % linebases + 1
        with open(self.path, "rb") as fh:
            fh.seek(fb_start)
            raw = fh.read(fb_end - fb_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode("ascii")


def write_fasta(path: str, sequences, line_width: int = 60):
    """Write (name, seq) pairs to FASTA."""
    with open(path, "w") as fh:
        for name, seq in sequences:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                fh.write(seq[i:i + line_width] + "\n")
