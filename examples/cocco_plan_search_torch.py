"""Cocco as the H100's execution planner: co-explore the fusion partition
and the on-chip working set (L2 and shared memory) for each architecture's
transformer block and print the resulting execution plans.

    PYTHONPATH=src python examples/cocco_plan_search_torch.py [--arch glm4-9b]

``examples/cocco_plan_search.py`` on the port, with ``plan_h100`` in place
of ``plan_tpu``; the GA's cost batches run on ``--device`` (default
``cuda``; without a GPU, pass ``--device cpu``).

Equivalent CLI:

    PYTHONPATH=src python -m repro_torch plan-h100 [--arch glm4-9b]
"""

import argparse
import sys

from repro_torch.api import plan_h100
from repro_torch.api.cli import missing_device
from repro_torch.configs import ARCHS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default=None,
                    help="default: all archs")
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the cost batches run (default: cuda)")
    args = ap.parse_args(argv)
    if missing_device(args.device):
        return 2
    archs = [args.arch] if args.arch else ARCHS
    for arch in archs:
        plan = plan_h100(arch, sample_budget=args.samples,
                         device=args.device)
        print(plan.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
