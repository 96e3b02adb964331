"""The control and the planted faults at a test size on the CPU: the
plain reference in bfloat16 in the program's place fails the kernel
numbers' limits, and a run whose timed path has an answer altered where
it is produced comes out not correct."""

import pytest

from portbench import control, harness
from portbench.tests import tiny


@pytest.mark.parametrize("cell", ["phase-ont.small-variants",
                                  "polish-ont.haploid"])
def test_control_fails_and_the_program_passes(cell):
    (line,) = control.readings(cell, [31], 0.1, "", "cpu",
                               tiny.overrides(cell))
    limits = harness.load_cell(cell).limits
    kernel = [k for k in line["control"] if k in limits]
    assert kernel
    assert any(line["control"][k] > limits[k] for k in kernel), line
    assert all(line["program"][k] <= limits[k] for k in kernel), line


@pytest.mark.parametrize("cell,fault", [
    ("phase-ont.small-variants", "k1"), ("polish-ont.haploid", "banded"),
    ("polish-ont.haploid", "k1")])
def test_an_altered_answer_is_not_correct(cell, fault):
    c = harness.load_cell(cell, tiny.overrides(cell))
    res = harness.run(c, 32, 0.1, False, device="cpu",
                      fault=control.FAULTS[fault]())
    assert res["correct"] is False, res["checks"]
