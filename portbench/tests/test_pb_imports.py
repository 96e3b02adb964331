"""What a run loads: nothing of JAX or the JAX package (top-level module
names compared whole, since the port's name begins with the JAX
package's), and the reference and the generator nothing of the program."""

import json
import subprocess
import sys

from portbench import harness
from portbench.tests import tiny

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "margin_tpu"}


def _modules(code: str, *args) -> set:
    out = subprocess.run([sys.executable, "-c", code, ROOT, *args],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """Every module run.py loads for a cell, its harness driving one call
    of the cell at a test size on the CPU and reading every metric."""
    code = (
        "import sys, json; sys.path.insert(0, sys.argv[1])\n"
        "import portbench.run\n"
        "from portbench import harness\n"
        "cell = harness.load_cell('phase-ont.small-variants', json.loads("
        "sys.argv[2]))\n"
        "harness.run(cell, 4, 0.1, True, device='cpu')\n"
        "for m in cell.per_layer: harness._reader(m['name'])\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in "
        "sys.modules})))\n")
    tops = _modules(code, json.dumps(tiny.PHASE))
    assert "margin_tpu_torch" in tops and "portbench" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert harness.forbidden_modules() == [] or "margin_tpu" not in \
        harness.FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys, json; sys.path.insert(0, sys.argv[1])\n"
        "import portbench.reference.hmm, portbench.reference.pairhmm\n"
        "import portbench.traffic.synth, portbench.truth\n"
        "import portbench.roofline, portbench.trace\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in "
        "sys.modules})))\n")
    tops = _modules(code)
    assert not tops & (FORBIDDEN | {"margin_tpu_torch"}), tops


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("margin_tpu_torch_lookalike", sys)
    try:
        assert "margin_tpu_torch_lookalike" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["margin_tpu_torch_lookalike"]
