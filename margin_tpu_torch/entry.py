"""Entry points of the port: the flagship kernel on one device, and a dry
run of the multi-device path.

Counterpart of the repository root's `__graft_entry__.py`. `entry`
returns the pair-HMM forward (kernel K1) with example inputs;
`dryrun_multichip` builds a (dp, sp) mesh and checks the sharded path at
three levels against the one-device run. Its device list may repeat a
device (`[cuda:0] * 2`, `[cpu] * 2`), which runs every split, pad, launch,
gather and reduce of the mesh on one device.

Opt-outs, by the JAX package's names: MARGIN_TPU_DRYRUN_KERNEL_ONLY
(level 1 only), MARGIN_TPU_DRYRUN_NO_DIPLOID (no level 2b),
MARGIN_TPU_DRYRUN_NO_MULTIHOST (no level 3).
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from margin_tpu_torch.ops import pairhmm
from margin_tpu_torch.params import StateMachineParams

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example_tables_and_batch(n_pairs=256, lx=29, ly=32, seed=0,
                              device="cuda"):
    """The JAX entry's tables and seeded pairs (__graft_entry__.py:6-20),
    on `device`."""
    rng = np.random.default_rng(seed)
    sm = StateMachineParams.default_nucleotide()
    tables = pairhmm.PairHmmTables.from_params(sm, device=device)
    pairs = [(rng.integers(0, 4, lx).astype(np.uint8),
              rng.integers(0, 4, ly).astype(np.uint8))
             for _ in range(n_pairs)]
    strands = rng.integers(0, 2, n_pairs).astype(np.int32)
    batch = pairhmm.make_batch(pairs, strands=strands, device=device)
    return tables, batch


def entry(device="cuda"):
    """Returns (fn, example_args): K1, the batched pair-HMM forward that
    scores (read substring x allele) pairs (the phase hot loop), with 256
    pairs of 29 x 32 on `device`."""
    def fn(tables, batch):
        return pairhmm.forward_total(tables, batch)

    return fn, _example_tables_and_batch(device=device)


def _quiet(*a, **k):
    pass


def _require(ok: bool, what: str) -> None:
    """A check of the dry run (kept under python -O, unlike assert)."""
    if not ok:
        raise AssertionError(what)


def _same(a: str, b: str, what: str) -> bytes:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        da, db = fa.read(), fb.read()
    _require(da == db, f"{what} diverges")
    return da


def _default_phase_set(tmp: str) -> dict:
    """A seeded synthetic phase set in three chunks (8 kb, 1 kb
    boundaries)."""
    from margin_tpu_torch.testing.synth import SynthConfig, write_dataset
    ds = write_dataset(f"{tmp}/phase_set", SynthConfig(
        contig_len=24_000, coverage=8.0, read_len=(1500, 3000), n_snv=12,
        n_sv=1, sv_len=(80, 120), sv_min_gap=8000, sv_expansion=150,
        seed=3))
    params = f"{tmp}/phase_params.json"
    with open(params, "w") as fh:
        json.dump({"include": os.path.abspath(ds.params),
                   "polish": {"chunkSize": 8000, "chunkBoundary": 1000}},
                  fh)
    return {"bam": ds.bam, "fasta": ds.fasta, "vcf": ds.vcf,
            "params": params, "region": None}


def _default_diploid_set(tmp: str) -> dict:
    """A seeded synthetic 700 bp diploid draft (one chunk, a het site
    every 150-250 bases)."""
    from margin_tpu_torch.testing.synth import (
        DiploidPolishSynthConfig, write_diploid_polish_dataset)
    ds = write_diploid_polish_dataset(f"{tmp}/diploid_set",
                                      DiploidPolishSynthConfig(
        contig_len=700, coverage=10.0, read_len=(250, 450),
        het_every=(150, 250), chunk_size=700, chunk_boundary=100, seed=5))
    return {"bam": ds.bam, "fasta": ds.draft, "params": ds.params,
            "region": None}


def dryrun_multichip(n_devices: int, devices=None,
                     phase_set: Optional[dict] = None,
                     diploid_set: Optional[dict] = None) -> dict:
    """Builds an n_devices (dp, sp) mesh over `devices` (default: every
    visible CUDA device) and checks the multi-device path:

    1. kernel: the sharded K1 step (the pair batch split over the mesh)
       and its per-slot sums reduced across it, on 8 x n pairs of 12 x 14;
    2. pipeline: a multi-chunk `run_phase` (threads=2) with every scoring
       batch sharded over the mesh against the one-device run: identical
       phased VCF, phaseset.bed and haplotag counts; 2b: a diploid polish
       the same way (identical hap FASTAs);
    3. hosts: a 2-process `--hosts` gloo group on the phase set against
       the threads=2 one-device run of level 2 (the same per-chunk RNG
       streams): identical phased VCF and phaseset.bed.

    phase_set: {"bam", "fasta", "vcf", "params" (a JSON path), "region"};
    diploid_set: {"bam", "fasta" (the draft), "params", "region"}; each
    defaults to a seeded synthetic set. The one-device runs take a mesh
    of the first device alone, which the drivers leave in place. Returns
    what was checked; any difference raises. The mesh is removed before
    returning."""
    from margin_tpu_torch.params import Params
    from margin_tpu_torch.parallel import executor
    from margin_tpu_torch.parallel import mesh as meshmod
    from margin_tpu_torch.phase.driver import run_phase

    mesh = meshmod.make_mesh(n_devices, devices=devices)
    root = mesh.flat[0]
    total = mesh.size
    report = {"mesh": mesh.shape, "devices": [str(d) for d in mesh.flat]}

    # --- level 1: sharded kernel + per-slot sums reduced over the mesh
    tables, batch = _example_tables_and_batch(n_pairs=8 * total, lx=12,
                                              ly=14, device=root)
    sharded = meshmod.shard_batch(batch, mesh)
    n_slots = 4
    step = meshmod.phase_step_sharded(mesh, n_slots)
    scores, slot_sums = step(tables, sharded,
                             np.arange(8 * total, dtype=np.int32) % n_slots)
    _require(tuple(scores.shape) == (8 * total,)
             and bool(torch.isfinite(scores).all()),
             f"sharded scores {tuple(scores.shape)}, not all finite")
    np.testing.assert_allclose(float(slot_sums.double().sum()),
                               float(scores.double().sum()), rtol=1e-5)
    report["level1"] = {"pairs": 8 * total, "shards": len(sharded)}
    if os.environ.get("MARGIN_TPU_DRYRUN_KERNEL_ONLY"):
        return report

    # --- level 2: multi-chunk phase pipeline over the mesh
    tmp = tempfile.mkdtemp(prefix="margin_dryrun_")
    single_ctx = executor.DeviceContext(meshmod.make_mesh(1, devices=[root]))
    try:
        ps = phase_set or _default_phase_set(tmp)
        args = dict(bam_file=ps["bam"], reference_fasta=ps["fasta"],
                    vcf_file=ps["vcf"], params=Params.load(ps["params"]),
                    region=ps.get("region"), threads=2, use_lut=True,
                    device=root, log=_quiet)
        executor.install(single_ctx)
        single = run_phase(output_base=f"{tmp}/single", **args)
        executor.enable_mesh(n_devices, devices=devices)
        _require(executor.context().mesh is not None, "no mesh installed")
        meshed = run_phase(output_base=f"{tmp}/mesh", **args)
        _require((meshed.hap1_count, meshed.hap2_count,
                  meshed.phased_het_count)
                 == (single.hap1_count, single.hap2_count,
                     single.phased_het_count),
                 "haplotag or phased het counts diverge on the mesh")
        for suffix in ("phased.vcf", "phaseset.bed"):
            _same(f"{tmp}/single.{suffix}", f"{tmp}/mesh.{suffix}",
                  f"{suffix} on the mesh")
        _require(meshed.hap1_count > 0 and meshed.hap2_count > 0,
                 "a haplotype tagged no read")
        report["level2"] = {"hap_counts": [meshed.hap1_count,
                                           meshed.hap2_count],
                            "phased_hets": meshed.phased_het_count}

        # --- level 2b: diploid polish through the sharded path
        if not os.environ.get("MARGIN_TPU_DRYRUN_NO_DIPLOID"):
            report["level2b"] = _dryrun_diploid(
                tmp, diploid_set or _default_diploid_set(tmp), root,
                single_ctx, n_devices, devices)

        # --- level 3: a 2-process --hosts group
        if not os.environ.get("MARGIN_TPU_DRYRUN_NO_MULTIHOST"):
            _dryrun_multihost(tmp, ps, root.type)
            report["level3"] = {"hosts": 2}
    finally:
        executor.disable_mesh()
        shutil.rmtree(tmp, ignore_errors=True)
    return report


def _dryrun_diploid(tmp, ds, root, single_ctx, n_devices, devices) -> dict:
    """Level 2b: the diploid polish of `ds` on one device and over the
    mesh; identical hap FASTAs and haplotype read counts."""
    from margin_tpu_torch.params import Params
    from margin_tpu_torch.parallel import executor
    from margin_tpu_torch.polish.driver import run_polish
    args = dict(bam_file=ds["bam"], reference_fasta=ds["fasta"],
                params=Params.load(ds["params"]), region=ds.get("region"),
                diploid=True, use_lut=True, device=root, log=_quiet)
    executor.install(single_ctx)
    single = run_polish(output_base=f"{tmp}/pol_single", **args)
    executor.enable_mesh(n_devices, devices=devices)
    meshed = run_polish(output_base=f"{tmp}/pol_mesh", **args)
    for suffix in ("hap1.fa", "hap2.fa"):
        data = _same(f"{tmp}/pol_single.{suffix}", f"{tmp}/pol_mesh.{suffix}",
                     f"diploid {suffix} on the mesh")
        _require(len(data) > 100, f"diploid {suffix} is {len(data)} bytes")
    _require((meshed.hap1_count, meshed.hap2_count)
             == (single.hap1_count, single.hap2_count),
             "diploid haplotype read counts diverge on the mesh")
    return {"hap_counts": [meshed.hap1_count, meshed.hap2_count]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dryrun_multihost(tmp: str, ps: dict, device_type: str) -> None:
    """Level 3: `python -m margin_tpu_torch phase` as 2 processes of a gloo
    group on a free localhost port (chunks partitioned by host, one
    all-gather, host 0 writes), against level 2's threads=2 one-device run
    (phase/driver.py, multihost.py)."""
    argv = ["phase", ps["bam"], ps["fasta"], ps["params"], ps["vcf"],
            "-a", "CRITICAL", "--device", device_type, "-o", f"{tmp}/mh",
            "--hosts", "2", "--coordinator", f"127.0.0.1:{_free_port()}"]
    if ps.get("region"):
        argv += ["-r", ps["region"]]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "margin_tpu_torch"] + argv
        + ["--host-id", str(h)], env=env, cwd=_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for h in range(2)]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        _require(p.returncode == 0, f"multi-host dryrun host failed:\n{o}")
    for suffix in ("phased.vcf", "phaseset.bed"):
        _same(f"{tmp}/single.{suffix}", f"{tmp}/mh.{suffix}",
              f"{suffix} multi-host")
