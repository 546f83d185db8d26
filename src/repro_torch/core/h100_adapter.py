"""Cocco on the H100: the paper's co-exploration as the card's execution
planner (the JAX package's ``repro.core.tpu_adapter.plan_architecture``,
with an NVIDIA H100 SXM5 in place of its accelerator).

The card's memory hierarchy maps onto the paper's model as

    HBM3 <-> external memory (DRAM),   L2 / shared memory <-> global buffer,

and a transformer block's op-DAG maps onto a Cocco computation graph whose
rows are tokens (:func:`repro_torch.core.tpu_adapter.build_block_graph`):
pointwise ops are F=1, s=1 edges and attention over the sequence is a FULL
edge.  Running the co-exploration over this graph under the card's fixed
buffer chooses (a) which ops fuse into regions whose working set stays on
chip and (b) the smallest rung of :data:`GLB_CANDIDATES` that holds the
winning plan's claimed working set.  Every GA generation's cost batch goes
through the ``torch`` executor, so on ``device="cuda"`` it is one B1 launch
(``csrc/finish_batch.cu``).

``ExecutionPlan.block_m`` is reported as the reference reports it (rows
of the widest fused group that fit half the budget, a power of two); like
the reference, nothing feeds it to the kernels' tiles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Sequence

from repro_torch.models.config import ModelConfig

from .cost import MB, AcceleratorConfig
from .tpu_adapter import build_block_graph

if TYPE_CHECKING:  # repro_torch.api imports repro_torch.core
    from repro_torch.api import ExploreResult

KB = 1024

# NVIDIA H100 SXM5 (datasheet, and the "NVIDIA H100 Tensor Core GPU
# Architecture" whitepaper for the per-SM figures)
N_SMS = 132                          # whitepaper: 132 SMs on H100 SXM5
SMEM_PER_SM = 228 * KB               # whitepaper: up to 228 KB shared memory/SM
SMEM_BYTES = N_SMS * SMEM_PER_SM     # 30,818,304 B across the card
L2_BYTES = 50 * MB                   # whitepaper: 50 MB L2 cache
HBM_BYTES_PER_SEC = 3.35e12          # datasheet: HBM3, 3.35 TB/s

H100_ACC = AcceleratorConfig(
    # the global buffer is the L2: the on-chip store every SM shares and
    # that outlives a kernel launch, as a fused group's tensors must
    glb_bytes=L2_BYTES,
    wbuf_bytes=0,
    shared=True,                     # activations and weights share it
    # whitepaper: 2048 dense BF16 FMA per clock per SM (4 tensor cores);
    # x 132 SMs x 1.83 GHz = 494.7e12 MAC/s, the datasheet's 989 TFLOP/s
    # dense BF16
    macs_per_cycle=N_SMS * 2048,
    freq_hz=1.83e9,
    dram_bytes_per_sec=HBM_BYTES_PER_SEC,
    # the energy constants (e_dram_pj_per_byte, e_mac_pj, ...) keep the
    # cost model's defaults: the "ema" objective searched here counts
    # bytes and does not read them
)

# Buffer budgets a plan may claim, smallest first; the plan takes the
# smallest rung that holds its working set:
#   8, 16 MB  a group that leaves most of the L2 to the weights and the
#             next group's operands streaming past it;
#   25 MB     half the L2: a group double-buffered against the next;
#   SMEM      the shared memory of every SM at once, what one persistent
#             kernel holds resident;
#   L2        the whole L2;
#   L2 + SMEM the on-chip total.
GLB_CANDIDATES = (8 * MB, 16 * MB, 25 * MB, SMEM_BYTES, L2_BYTES,
                  L2_BYTES + SMEM_BYTES)


@dataclass
class ExecutionPlan:
    """The planner's output for one block.  ``glb_budget`` is the
    reference's ``vmem_budget``: the rung of the buffer ladder the plan's
    working set needs."""

    arch: str
    layer_idx: int
    glb_budget: int
    fusion_groups: List[List[str]]
    hbm_bytes: int
    hbm_bytes_unfused: int
    block_m: int                    # suggested kernel row-block size
    result: Optional["ExploreResult"] = None

    @property
    def traffic_saving(self) -> float:
        if self.hbm_bytes_unfused <= 0:
            return 0.0
        return 1.0 - self.hbm_bytes / self.hbm_bytes_unfused

    def summary(self) -> str:
        groups = " | ".join("+".join(gr) for gr in self.fusion_groups)
        return (f"{self.arch} L{self.layer_idx}: on-chip "
                f"{self.glb_budget / MB:.1f}MB, "
                f"HBM traffic -{self.traffic_saving*100:.0f}% vs unfused, "
                f"block_m={self.block_m}, groups: {groups}")


def plan_architecture(cfg: ModelConfig, tokens_local: int = 8192,
                      layer_idx: Optional[int] = None,
                      sample_budget: int = 3_000, seed: int = 0, *,
                      acc: AcceleratorConfig = H100_ACC,
                      candidates: Sequence[int] = GLB_CANDIDATES,
                      device: str = "cuda",
                      eval_backend: str = "torch") -> ExecutionPlan:
    """Run the paper's co-exploration over one block of the arch and
    derive the execution plan (fusion groups, buffer budget, block size)
    for the accelerator ``acc`` and its budget ladder ``candidates``.
    The GA's cost batches run on ``eval_backend`` (``torch`` on
    ``device``: one B1 launch a generation on ``cuda``); every backend
    gives the same plan."""
    from repro_torch.api import ExploreSpec, GAOptions
    from repro_torch.api import run as api_run
    from repro_torch.core.engine import make_executor
    from repro_torch.core.ga import HWSpace, Objective

    from .cost import CachedEvaluator
    from .memory import subgraph_footprint

    if layer_idx is None:
        pre, p, reps, rem = cfg.layout()
        layer_idx = pre  # first scanned layer: the repeating workhorse
    g = build_block_graph(cfg, layer_idx, tokens_local)
    out_tile = max(128, tokens_local // 64)
    # the buffer is fixed hardware: partition under the fixed budget
    # (Formula 1); the claimed working set of the winning plan picks the
    # rung
    ev = CachedEvaluator(g, out_tile=out_tile,
                         executor=make_executor(eval_backend, 1, device))
    spec = ExploreSpec(workload=g.name, strategy="ga",
                       objective=Objective(metric="ema", alpha=None),
                       hw=HWSpace(mode="fixed", base=acc),
                       sample_budget=sample_budget, seed=seed,
                       out_tile=out_tile, options=GAOptions(population=48))
    res = api_run(spec, graph=g, ev=ev)
    unfused = ev.plan([{v} for v in range(g.n)], acc)
    groups = [[g.nodes[v].name for v in sorted(s)] for s in res.groups
              if len(s) > 0]
    claimed = max((subgraph_footprint(g, s, out_tile=out_tile).total_bytes
                   for s in res.groups), default=1)
    budget = min((c for c in candidates if c >= claimed),
                 default=candidates[-1])
    # block_m: rows of the widest fused group that fit half the budget
    widest = max((sum(g.nodes[v].line_bytes for v in s) for s in res.groups),
                 default=1)
    block_m = max(128, min(tokens_local, (budget // 2) // max(widest, 1)))
    block_m = 1 << (block_m.bit_length() - 1)  # round down to pow2
    return ExecutionPlan(
        arch=cfg.name, layer_idx=layer_idx, glb_budget=budget,
        fusion_groups=groups, hbm_bytes=res.plan.ema_total,
        hbm_bytes_unfused=unfused.ema_total, block_m=block_m, result=res,
    )
