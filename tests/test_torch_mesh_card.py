"""The launch guard of the port's kernels and K1 through the multi-device
scoring context on the card. This file imports no JAX, so its `cuda`
test runs on the card machine as it is:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_mesh_card.py

On the CPU the guard is checked with stand-ins for torch.cuda.device and
torch.cuda.current_stream, and by a scan of the package.
"""

import os

import numpy as np
import pytest
import torch

from margin_tpu_torch import _ext, entry
from margin_tpu_torch.ops import pairhmm
from margin_tpu_torch.parallel import executor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_launch_runs_on_the_tensors_device(monkeypatch):
    """_ext.launch makes the tensors' device current around the C entry
    and passes that device's current stream last."""
    seen = []

    class Device:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            seen.append(("enter", self.dev))

        def __exit__(self, *exc):
            seen.append(("exit", self.dev))

    class Stream:
        cuda_stream = 1234
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream)
    dev = torch.device("cuda", 1)

    def entry_point(*args):
        seen.append(("call", args))
        return 0
    assert _ext.launch(dev, entry_point, 7, 8) == 0
    assert seen == [("enter", dev), ("call", (7, 8, 1234)), ("exit", dev)]


def test_every_launcher_takes_the_guard():
    """No wrapper reads a stream itself: each ctypes launch goes through
    _ext.launch."""
    pkg = os.path.join(ROOT, "margin_tpu_torch")
    hits = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py") and f != "_ext.py":
                with open(os.path.join(dirpath, f)) as fh:
                    if "cuda_stream" in fh.read():
                        hits.append(f)
    assert not hits, hits


@pytest.mark.cuda
def test_k1_through_context_on_one_card_twice():
    """K1 through the context on [cuda:0] * 2: the one-device scores bit
    for bit, one launch a shard, slot sums within rtol 1e-6 of the float64
    host sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tables, batch = entry._example_tables_and_batch(49, 9, 11,
                                                    device="cuda")
    single = executor.score_batch(tables, batch, use_lut=True)
    try:
        executor.enable_mesh(devices=["cuda:0"] * 2)
        before = pairhmm.FORWARD_TOTAL.launches
        got = executor.score_batch(tables, batch, use_lut=True)
        assert pairhmm.FORWARD_TOTAL.launches - before == 2
        assert np.array_equal(got, single)
        _, sums = executor.score_slot_sums(tables, batch,
                                           np.arange(49) % 3, 3,
                                           use_lut=True)
    finally:
        executor.disable_mesh()
    host = np.zeros(3)
    for i, s in enumerate(single):
        host[i % 3] += float(s)
    np.testing.assert_allclose(sums, host, rtol=1e-6)
