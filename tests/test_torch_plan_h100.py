"""Cocco as the H100's execution planner (``repro_torch.core.h100_adapter``).

* Given the JAX package's accelerator constants and buffer ladder (handed
  in by the test), the port's ``plan_architecture`` returns the
  reference's plan exactly: groups, HBM bytes fused and unfused, budget
  and ``block_m``, on every bundled config;
* with the H100's constants it fuses and cuts HBM traffic on the configs
  ``tests/test_system.py`` plans;
* ``python -m repro_torch plan-h100`` prints one summary per config, and
  ``plan-tpu`` exits 2 naming ``plan-h100``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import tpu_adapter as ref_adapter  # noqa: E402
from repro_torch.api import plan_h100  # noqa: E402
from repro_torch.api.cli import main  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.cost import AcceleratorConfig  # noqa: E402
from repro_torch.core.h100_adapter import (  # noqa: E402
    GLB_CANDIDATES,
    H100_ACC,
    plan_architecture,
)


def _ref_acc() -> AcceleratorConfig:
    return AcceleratorConfig(**dataclasses.asdict(ref_adapter.TPU_ACC))


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_equals_the_reference_under_its_constants(arch):
    acc = _ref_acc()
    for budget in (300, 800):
        for seed in (0, 1):
            ref = ref_adapter.plan_architecture(
                ref_get_config(arch), sample_budget=budget, seed=seed)
            got = plan_architecture(
                get_config(arch), sample_budget=budget, seed=seed, acc=acc,
                candidates=ref_adapter.VMEM_CANDIDATES, device="cpu")
            assert (got.arch, got.layer_idx) == (ref.arch, ref.layer_idx)
            assert got.fusion_groups == ref.fusion_groups, (budget, seed)
            assert got.hbm_bytes == ref.hbm_bytes, (budget, seed)
            assert got.hbm_bytes_unfused == ref.hbm_bytes_unfused
            assert got.glb_budget == ref.vmem_budget, (budget, seed)
            assert got.block_m == ref.block_m, (budget, seed)
            assert got.traffic_saving == ref.traffic_saving


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b", "xlstm-350m"])
def test_h100_plan_fuses_and_saves_traffic(arch):
    plan = plan_h100(arch, sample_budget=800, seed=0, device="cpu")
    assert plan.traffic_saving > 0.3, plan.summary()
    assert any(len(gr) > 1 for gr in plan.fusion_groups)
    assert plan.block_m >= 128
    assert plan.glb_budget in GLB_CANDIDATES
    assert plan.result.acc == H100_ACC


def test_h100_constants_are_the_cards():
    # HBM3 3.35 TB/s; dense BF16 989.4 TFLOP/s = 2 x MACs/cycle x clock;
    # L2 50 MB; 228 KB shared memory on each of 132 SMs
    assert H100_ACC.dram_bytes_per_sec == 3.35e12
    assert abs(2 * H100_ACC.macs_per_cycle * H100_ACC.freq_hz
               - 989.4e12) < 0.1e12
    assert H100_ACC.glb_bytes == 50 * 2**20
    assert GLB_CANDIDATES[-1] == 50 * 2**20 + 132 * 228 * 1024
    assert list(GLB_CANDIDATES) == sorted(GLB_CANDIDATES)


def test_plan_h100_cli_prints_ten_summaries(capsys):
    assert main(["--device", "cpu", "plan-h100", "--samples", "100",
                 "--tokens", "2048"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == len(ARCHS) == 10
    for arch, line in zip(ARCHS, lines):
        assert line.startswith(f"{arch} L"), line
        assert "HBM traffic" in line and "groups:" in line


def test_plan_h100_cli_one_arch_matches_the_api(capsys):
    assert main(["--device", "cpu", "plan-h100", "--arch", "tinyllama-1.1b",
                 "--samples", "200", "--tokens", "2048"]) == 0
    out = capsys.readouterr().out.strip()
    plan = plan_h100("tinyllama-1.1b", tokens=2048, sample_budget=200,
                     device="cpu")
    assert out == plan.summary()


def test_plan_tpu_exits_2_naming_plan_h100(capsys):
    assert main(["plan-tpu", "--arch", "tinyllama-1.1b"]) == 2
    assert "plan-h100" in capsys.readouterr().err
    assert main(["--device", "cpu", "plan-tpu"]) == 2
    assert "plan-h100" in capsys.readouterr().err
