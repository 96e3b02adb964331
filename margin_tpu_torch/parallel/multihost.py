"""Multi-host scale-out: a torch.distributed process group on gloo and the
one collective gather of the per-chunk stitch inputs.

Counterpart of `margin_tpu/parallel/multihost.py`. Hosts stay
embarrassingly parallel: params and reference replicated, chunks
partitioned by index (chunk_idx % N == host id), and one collective, an
all-gather of the serialized chunk results (stitching.c:1573-1588's merge
inputs), after which host 0 writes the outputs. gloo runs on the host's
CPU and network, so the group needs no device.

Usage (one process per host, the same command line everywhere):

    python -m margin_tpu_torch phase ... --hosts N --host-id I \\
        --coordinator HOST:PORT

Without --coordinator the group rendezvous through MASTER_ADDR and
MASTER_PORT (torch's env:// init).
"""

from __future__ import annotations

import datetime
import functools
import pickle
import sys
import zlib
from typing import List, Optional

import torch
import torch.distributed as dist

# how long a collective (or the rendezvous) waits for a host that never
# comes: a host that raises must not leave its peers waiting forever
TIMEOUT_S = 1800


def init(coordinator: Optional[str], num_hosts: int, host_id: int) -> None:
    """Join the gloo group of `num_hosts` processes as rank `host_id`;
    idempotent."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=(f"tcp://{coordinator}" if coordinator
                             else "env://"),
        world_size=int(num_hosts), rank=int(host_id),
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def join(hosts, log=print):
    """Join the group that hosts=(coordinator, N, host_id) names and
    return this module, the drivers' `mh`; None when hosts is None."""
    if hosts is None:
        return None
    coordinator, n_hosts, hid = hosts
    init(coordinator, int(n_hosts), int(hid))
    log(f"> Multi-host: host {hid}/{n_hosts} via {coordinator}")
    return sys.modules[__name__]


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def scoped(run):
    """Decorate a driver entry point: the process group its `hosts` run
    joined is destroyed when the run ends, also on error."""
    @functools.wraps(run)
    def wrapper(*args, **kwargs):
        had_group = dist.is_initialized()
        try:
            return run(*args, **kwargs)
        finally:
            if not had_group:
                shutdown()
    return wrapper


def allgather_bytes(payload: bytes) -> List[bytes]:
    """All-gather one variable-length byte string per host, in two phases
    (the lengths, then the buffers padded to the longest). Every host gets
    the same list, index == host id."""
    n = num_hosts()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([len(payload)], dtype=torch.int64))
    lens = [int(t.item()) for t in lens]
    width = max(max(lens), 1)
    buf = torch.zeros(width, dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
    bufs = [torch.empty(width, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(bufs, buf)
    return [b[:ln].numpy().tobytes() for b, ln in zip(bufs, lens)]


def allgather_objects(obj) -> List:
    """All-gather one picklable object per host."""
    return [pickle.loads(b) for b in allgather_bytes(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))]


def dumps_z(obj) -> bytes:
    """Wire encoding of the stitch-input gathers: pickled, then zlib level
    1 (sequence-heavy chunk records shrink ~5x)."""
    return b"Z1" + zlib.compress(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), 1)


def loads_z(b: bytes):
    """Inverse of dumps_z; takes a plain pickle too."""
    if b[:2] == b"Z1":
        return pickle.loads(zlib.decompress(b[2:]))
    return pickle.loads(b)


def host_id() -> int:
    return dist.get_rank()


def num_hosts() -> int:
    return dist.get_world_size()


def barrier(name: str = "margin") -> None:
    """Wait for every host (`name` labels the call site, as in the JAX
    package's sync_global_devices)."""
    dist.barrier()
