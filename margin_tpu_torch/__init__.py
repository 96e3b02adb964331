"""margin_tpu_torch: `margin phase` on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `margin_tpu`, which stays in the repository as
the reference. Host code (BAM/VCF/FASTA I/O, chunking, read extraction,
the read-partition HMM, stitching) is copied from it; the device work runs
in hand-written CUDA kernels (`csrc/`), each with a plain PyTorch twin
used on the CPU:

  K1      ops/pairhmm.py      dense pair-HMM total forward
  K2-fwd  ops/cuda_banded.py  banded forward over a pack of problems
  K2-bwd  ops/cuda_banded.py  banded backward + posteriors

The package imports torch and numpy and nothing of JAX or `margin_tpu`.
Kernels and host C++ engines are built at first use into `_build/`
(`_ext.py`).
"""

__version__ = "0.1.0"

from margin_tpu_torch.alphabet import Alphabet  # noqa: F401
from margin_tpu_torch.rle import RleString  # noqa: F401
