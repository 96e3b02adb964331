"""Per-chunk checkpoint/resume for the phase and polish drivers.

A TPU-build addition (no reference equivalent; SURVEY.md §5): long
whole-genome runs are chunked, so a killed run can resume by replaying
per-chunk payloads instead of recomputing them. Each chunk's payload
(its result record, any root-VCF-entry mutations, and the RNG state after
the chunk) is pickled under `<outputBase>.checkpoint/`; a `meta.json`
guard invalidates stale directories when the inputs change. The directory
is removed when the run completes.
"""

from __future__ import annotations

import gzip
import json
import os
import pickle
import shutil
from typing import Any, Optional


class ChunkCheckpointer:
    def __init__(self, directory: str, enabled: bool = True,
                 meta: Optional[dict] = None, log=print):
        self.directory = directory
        self.enabled = enabled
        self.loaded = 0
        self.bytes_written = 0
        self._log = log
        if not enabled:
            return
        meta = meta or {}
        meta_path = os.path.join(directory, "meta.json")
        if os.path.isdir(directory):
            stale = True
            try:
                with open(meta_path) as fh:
                    stale = json.load(fh) != meta
            except Exception:
                pass
            if stale:
                log(f"> Discarding stale checkpoint directory {directory}")
                shutil.rmtree(directory)
        os.makedirs(directory, exist_ok=True)
        with open(meta_path, "w") as fh:
            json.dump(meta, fh)

    def _path(self, chunk_idx: int) -> str:
        return os.path.join(self.directory, f"chunk_{chunk_idx:05d}.pkl")

    def load(self, chunk_idx: int) -> Optional[Any]:
        if not self.enabled:
            return None
        path = self._path(chunk_idx)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as fh:
                head = fh.read(2)
            opener = gzip.open if head == b"\x1f\x8b" else open
            with opener(path, "rb") as fh:
                payload = pickle.load(fh)
            self.loaded += 1
            return payload
        except Exception:
            return None  # partial write from a killed run: recompute

    def save(self, chunk_idx: int, payload: Any) -> None:
        if not self.enabled:
            return
        path = self._path(chunk_idx)
        tmp = path + ".tmp"
        # gzip level 1: pickled per-chunk results are numpy/string heavy
        # and compress 3-5x, which bounds WGS-scale checkpoint disk
        with gzip.open(tmp, "wb", compresslevel=1) as fh:
            pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)
        self.bytes_written += os.path.getsize(tmp)
        os.replace(tmp, path)  # atomic: no torn checkpoints

    def finalize(self) -> None:
        """Remove the checkpoint directory after a successful run."""
        if self.enabled and os.path.isdir(self.directory):
            shutil.rmtree(self.directory)

    def report(self) -> str:
        return (f"checkpoint: {self.bytes_written / 1e6:.1f} MB written, "
                f"{self.loaded} chunks resumed")


def snapshot_vcf_entries(vcf_entries_map, ref_name: str, start: int,
                         end: int) -> list:
    """Capture the per-chunk phasing mutations on root VCF entries
    (fields written by update_original_vcf_entries and the filtered-entry
    vote) so a resumed run can replay them."""
    out = []
    for e in vcf_entries_map.get(ref_name, []):
        if start <= e.ref_pos < end:
            out.append((e.line_idx, e.was_updated, e.phased_gt1, e.phased_gt2,
                        e.genotype_prob, e.haplotype1_prob, e.haplotype2_prob,
                        [set(s) for s in e.allele_idx_to_read_ids]
                        if e.allele_idx_to_read_ids is not None else None))
    return out


def apply_vcf_snapshot(vcf_entries_map, ref_name: str, snapshot: list) -> None:
    by_line = {e.line_idx: e for e in vcf_entries_map.get(ref_name, [])}
    for (line_idx, was_updated, gt1, gt2, gprob, h1prob, h2prob,
         read_sets) in snapshot:
        e = by_line.get(line_idx)
        if e is None:
            continue
        e.was_updated = was_updated
        e.phased_gt1 = gt1
        e.phased_gt2 = gt2
        e.genotype_prob = gprob
        e.haplotype1_prob = h1prob
        e.haplotype2_prob = h2prob
        if read_sets is not None:
            e.allele_idx_to_read_ids = [set(s) for s in read_sets]
