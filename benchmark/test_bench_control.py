"""The control comes out not correct: the plain reference computed in the
precision below the configuration's (TF32 below float32) and put in the
program's place (``control.py``), at a size a test run holds, on the CPU,
judged by the cell's own limits; the program's own readings at that size
come out correct beside it."""
import pytest
import torch

from benchmark import control, reference
from benchmark.test_bench_faults import CELLS, small


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    wl, config = small(name)
    rows = control.readings(name, [2**31 + 3], 0.5, device="cpu", wl=wl, config=config,
                            log=lambda s: None, control_items=1)
    (row,) = rows
    assert row["precision"] == "tf32"
    assert row["program_correct"], row["program"]
    assert row["control_correct"] is False, row["control"]


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-12, -(1.0 + 3 * 2**-12), 3.0e-5])
    r = reference._to_tf32(x)
    assert r.tolist()[:4] == [1.0, 1.0 + 2**-10, 1.0, -(1.0 + 2**-10)]
    assert abs(r[4] / x[4] - 1.0) <= 2**-11
    assert reference.control_precision("float32").name == "tf32"
    assert reference.control_precision("float64").dtype == torch.float32
