"""Quickstart on the PyTorch port: Cocco's hardware-mapping co-exploration
on ResNet-50, its cost batches evaluated on the GPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``examples/quickstart.py`` through :mod:`repro_torch.api`: one
ExploreSpec, the Halide-greedy and Irregular-NN DP baselines and Cocco's GA
from the strategy registry (all sharing one cost evaluator, whose batches
go through the streaming-block kernel on ``--device cuda``, the default),
ranked.  It prints what ``examples/quickstart.py`` prints, byte for byte,
on either device.  Without a GPU, pass ``--device cpu``.

Equivalent CLI:

    PYTHONPATH=src python -m repro_torch --device cuda compare \\
        --workload resnet50 --strategies greedy,dp,ga --metric energy \\
        --alpha 0.002 --hw-mode shared --budget 4000 --opt population=60
"""

import argparse
import sys

from repro_torch.api import ExploreSpec, GAOptions, compare
from repro_torch.api.cli import missing_device
from repro_torch.core import HWSpace, Objective


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the cost batches run (default: cuda)")
    args = ap.parse_args(argv)
    if missing_device(args.device):
        return 2
    spec = ExploreSpec(
        workload="resnet50",
        strategy="ga",
        objective=Objective(metric="energy", alpha=0.002),
        hw=HWSpace(mode="shared"),
        sample_budget=4000,
        seed=0,
        options=GAOptions(population=60),
    )
    results = {r.strategy: r for r in compare(spec, ["greedy", "dp", "ga"],
                                              device=args.device)}

    greedy_plan = results["greedy"].plan
    dp_plan = results["dp"].plan
    print(f"greedy (Halide):      EMA {greedy_plan.ema_total/1e6:8.2f} MB")
    print(f"DP (Irregular-NN):    EMA {dp_plan.ema_total/1e6:8.2f} MB")

    res = results["ga"]
    print(f"\nCocco co-exploration: {res.summary()}")
    print(f"  {res.n_subgraphs} subgraphs; largest fuses "
          f"{max(len(s) for s in res.groups)} layers")
    print(f"  vs greedy EMA: {res.plan.ema_total / greedy_plan.ema_total:.2f}x")

    # every run is a reproducible artifact: spec and result round-trip JSON
    print(f"\nspec JSON: {len(spec.to_json())} bytes; "
          f"result JSON: {len(res.to_json())} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
