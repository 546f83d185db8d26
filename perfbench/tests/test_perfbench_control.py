"""The control: the reference in fp8, in the program's place, has to come
out as not correct.  On the card (marked ``gpu``) at each cell's own size
on three seeds; on the CPU at smoke widths, that its gaps exceed the
fp32 program's."""

import pytest
import torch

from perfbench import control, spec
from perfbench.tests import smoke_cells

CELLS = ("deepseek_v2_4l.prefill_short", "jamba_8l.prefill_short",
         "deepseek_v2_4l.decode_long")
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the cells run the port's CUDA kernels")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_each_cells_limit_on_the_card(workload):
    needs_gpu()
    cell = spec.cell(workload)
    limit = cell["limits"]["mean_gap"]
    for seed in SEEDS:
        r = control.readings(cell, seed, "cuda:0")
        assert r["control"]["mean"] > limit, r
        assert r["program"]["mean"] <= limit, r


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-v0.1-52b"])
def test_the_control_reads_wider_gaps_than_the_program(arch):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = control.readings(smoke_cells.cell(arch), 2**31 + 7, "cpu")
    finally:
        torch.set_num_threads(n)
    assert r["program"]["mean"] <= 1e-5
    assert r["control"]["mean"] > 10 * max(r["program"]["mean"], 1e-5)
    assert r["program"]["tokens"] == r["control"]["tokens"] == 16
