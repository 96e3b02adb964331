"""BGZF (blocked gzip) reader/writer.

Host-side replacement for htslib's bgzf engine (the reference links htslib
for all BAM/VCF I/O; SURVEY.md §2.4). Pure-Python + zlib here; the C++
`native/` fast path mirrors this layout.

A BGZF file is a sequence of gzip members, each with an extra 'BC' subfield
giving the total block size; virtual offsets are (compressed_offset << 16) |
offset_within_uncompressed_block.
"""

from __future__ import annotations

import struct
import zlib

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


class BgzfReader:
    """Random-access BGZF reader with a one-block cache."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._block_coffset = -1
        self._block_data = b""
        self._next_coffset = 0
        self._within = 0

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -- block level ---------------------------------------------------------

    def _load_block(self, coffset: int) -> bool:
        """Read+decompress the block at compressed offset. Returns False at EOF."""
        if coffset == self._block_coffset:
            return True
        self._fh.seek(coffset)
        header = self._fh.read(18)
        if len(header) < 18:
            self._block_coffset = coffset
            self._block_data = b""
            self._next_coffset = coffset
            return False
        if header[0] != 0x1F or header[1] != 0x8B:
            raise ValueError(f"Not a BGZF block at offset {coffset}")
        xlen = struct.unpack_from("<H", header, 10)[0]
        extra = header[12:18]
        if xlen > 6:
            extra += self._fh.read(xlen - 6)
        # find BC subfield
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from("<H", extra, i + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", extra, i + 4)[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block missing BC subfield")
        payload_len = bsize - 12 - xlen - 8
        payload = self._fh.read(payload_len)
        self._fh.seek(4, 1)  # skip CRC
        isize = struct.unpack("<I", self._fh.read(4))[0]
        data = zlib.decompress(payload, -15) if payload_len > 0 else b""
        assert len(data) == isize
        self._block_coffset = coffset
        self._block_data = data
        self._next_coffset = coffset + bsize
        return len(data) > 0 or bsize > 28  # empty EOF block -> False

    # -- stream level --------------------------------------------------------

    def seek_virtual(self, voffset: int):
        coffset = voffset >> 16
        within = voffset & 0xFFFF
        self._load_block(coffset)
        self._within = within

    def tell_virtual(self) -> int:
        return (self._block_coffset << 16) | self._within

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._block_coffset < 0:
                if not self._load_block(0):
                    break
            avail = len(self._block_data) - self._within
            if avail <= 0:
                nxt = self._next_coffset
                ok = self._load_block(nxt)
                self._within = 0
                if not ok or len(self._block_data) == 0:
                    break
                continue
            take = min(avail, n)
            out += self._block_data[self._within:self._within + take]
            self._within += take
            n -= take
        return bytes(out)


class BgzfWriter:
    """Streaming BGZF writer (64 KB blocks; level from MARGIN_TPU_BGZF_LEVEL,
    default 1 — same speed-oriented default as the native writer)."""

    MAX_BLOCK = 0xFF00

    def __init__(self, path: str, level: int = None):
        if level is None:
            import os
            try:
                level = int(os.environ.get("MARGIN_TPU_BGZF_LEVEL", "1"))
            except ValueError:
                level = 1
            if not 0 <= level <= 9:
                level = 1
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._level = level

    def write(self, data: bytes):
        self._buf += data
        while len(self._buf) >= self.MAX_BLOCK:
            self._flush_block(self._buf[:self.MAX_BLOCK])
            del self._buf[:self.MAX_BLOCK]

    def tell_virtual(self) -> int:
        """Virtual offset of the next byte written (htslib bgzf_tell):
        coffset<<16 | uoffset. write() flushes eagerly, so the pending
        buffer always fits inside the block starting at the current file
        position."""
        return (self._fh.tell() << 16) | len(self._buf)

    def _flush_block(self, data: bytes):
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        comp = co.compress(bytes(data)) + co.flush()
        bsize = len(comp) + 25 + 1
        header = struct.pack(
            "<BBBBIBBHBBHH",
            0x1F, 0x8B, 8, 4,  # magic, deflate, FEXTRA
            0, 0, 0xFF,        # mtime, xfl, os
            6,                 # xlen
            0x42, 0x43, 2,     # 'B','C', len 2
            bsize - 1)
        crc = zlib.crc32(bytes(data)) & 0xFFFFFFFF
        self._fh.write(header + comp + struct.pack("<II", crc, len(data)))

    def close(self):
        if self._buf:
            self._flush_block(self._buf)
            self._buf = bytearray()
        self._fh.write(_BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as fh:
        head = fh.read(18)
    return (len(head) >= 18 and head[0] == 0x1F and head[1] == 0x8B
            and (head[3] & 4) != 0 and head[12] == 0x42 and head[13] == 0x43)
