"""tagFromIds: haplotag a BAM from a read-id -> haplotype TSV.

Copy of `margin_tpu/tools/tag_from_ids.py` with the port's imports.

Parity: tools/tagFromIds.c — TSV lines `read_id\t[none|H0|H1|H2|HP:i:N]`,
reads absent from the file keep HP removed (tag value 0)."""

from __future__ import annotations

import argparse
import sys

from margin_tpu_torch.io import bam as bamio

_TAG_MAP = {"H1": 1, "HP:i:1": 1, "H2": 2, "HP:i:2": 2,
            "none": 0, "H0": 0, "HP:i:0": 0}


def parse_tag_file(path: str):
    tags = {}
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                continue
            ht = _TAG_MAP.get(parts[1])
            if ht is None:
                raise ValueError(f"Unrecognized haplotype info: {parts[1]}")
            tags[parts[0]] = ht
    return tags


def main(argv=None):
    p = argparse.ArgumentParser(prog="tagFromIds")
    p.add_argument("bam")
    p.add_argument("tag_info_file")
    # tagFromIds.c:27: OUT_BAM_FILE and THREAD_COUNT are positional
    p.add_argument("out_bam", nargs="?", default=None)
    p.add_argument("threads", nargs="?", type=int, default=1,
                   help="accepted for compatibility; unused")
    p.add_argument("-o", "--outputBase", default="output")
    args = p.parse_args(argv)
    tags = parse_tag_file(args.tag_info_file)
    out_path = args.out_bam or f"{args.outputBase}.haplotagged.bam"
    counts = {0: 0, 1: 0, 2: 0}
    with bamio.open_alignment(args.bam) as reader:
        with bamio.BamWriter(out_path, reader.header) as writer:
            for rec in reader:
                hp = tags.get(rec.name, 0)
                counts[hp] += 1
                writer.write_raw(bamio.set_hp_tag(rec.raw, rec, hp))
    print(f"Wrote {out_path}: H1 {counts[1]}, H2 {counts[2]}, untagged {counts[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
