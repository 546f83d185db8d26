"""Memory management for subgraph execution (paper §3.2, Fig. 7–8).

The global buffer is carved into logical per-tensor regions by a *buffer region
manager*: a 2N-deep register file holding (start, end) addresses for up to N
regions.  Each tensor gets a MAIN region (the sliding tile, ``x`` rows) and —
when the tile is narrower than the full feature-map width — a SIDE region
holding the horizontally-overlapping rows for reuse across the row loop.

In our row-granular model tiles span the full width (line-buffer style), so the
SIDE bytes are folded into MAIN for footprint purposes; the 2-D split is still
modelled so the region table and its area overhead match the paper's
demonstration (272 B table for N=64 regions, 17-bit addresses, 0.18% of a 1 MB
64-bit-wide buffer).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Set, Tuple

from .graph import Graph
from .tiling import SubgraphSchedule, derive_schedule


@dataclass(frozen=True)
class Region:
    tensor: int
    start: int          # byte address in the global buffer
    end: int            # exclusive
    kind: str           # "MAIN" | "SIDE"

    @property
    def size(self) -> int:
        return self.end - self.start


@dataclass
class RegionTable:
    """The buffer region manager state: one (start, end) pair per region."""

    capacity_bytes: int
    max_regions: int = 64
    regions: List[Region] = field(default_factory=list)

    def allocate(self, tensor: int, size: int, kind: str = "MAIN") -> Region:
        if len(self.regions) >= 2 * self.max_regions:
            raise MemoryError(f"region table full (N={self.max_regions})")
        start = self.regions[-1].end if self.regions else 0
        if start + size > self.capacity_bytes:
            raise MemoryError(
                f"global buffer overflow: need {start + size} of "
                f"{self.capacity_bytes} bytes"
            )
        r = Region(tensor, start, start + size, kind)
        self.regions.append(r)
        return r

    @property
    def used_bytes(self) -> int:
        return self.regions[-1].end if self.regions else 0

    # -- hardware overhead (paper: 272 B register file, 0.18% area) --------
    def table_bytes(self) -> int:
        addr_bits = max(1, math.ceil(math.log2(max(self.capacity_bytes, 2))))
        # one start + one end address per region entry, N entries
        bits = 2 * self.max_regions * addr_bits
        return math.ceil(bits / 8)

    def area_overhead_fraction(self, sram_mm2_per_mb: float = 1.2,
                               regfile_mm2_per_kb: float = 0.012) -> float:
        """Rough silicon ratio of the region table vs the buffer itself."""
        buf_mm2 = (self.capacity_bytes / 2**20) * sram_mm2_per_mb
        tbl_mm2 = (self.table_bytes() / 1024) * regfile_mm2_per_kb
        return tbl_mm2 / max(buf_mm2, 1e-12)


@dataclass
class FootprintReport:
    total_bytes: int
    per_tensor: Dict[int, int]
    main_bytes: int
    side_bytes: int
    fits: bool


def side_rows(F: int, s: int) -> int:
    """Horizontally-overlapping rows reserved in the SIDE region (F > s)."""
    return max(0, F - s)


def subgraph_footprint(
    g: Graph,
    nodes: Set[int],
    schedule: Optional[SubgraphSchedule] = None,
    capacity_bytes: Optional[int] = None,
    out_tile: int = 1,
    tile_width_fraction: float = 1.0,
) -> FootprintReport:
    """Global-buffer bytes needed to execute ``nodes`` as one subgraph.

    ``tile_width_fraction`` < 1 models 2-D tiling where the MAIN tile covers a
    fraction of the row and the SIDE region holds the overlap rows of the full
    width; with the default (line-buffer tiles spanning the full width) SIDE
    is zero and MAIN is ``x`` full rows.
    """
    sched = schedule or derive_schedule(g, nodes, out_tile=out_tile)
    per: Dict[int, int] = {}
    main_total = 0
    side_total = 0
    for t, ts in sched.tensors.items():
        line = g.nodes[t].line_bytes
        main = ts.x * max(1, int(line * tile_width_fraction))
        side = 0
        if tile_width_fraction < 1.0:
            # max window among this tensor's consumers inside the subgraph
            fmax, smin = 0, 1
            for e in g.edges:
                if e.src == t and e.dst in nodes and e.kind == "sliding":
                    fmax, smin = max(fmax, e.F), max(1, e.s)
            side = side_rows(fmax, smin) * line
        per[t] = main + side
        main_total += main
        side_total += side
    total = main_total + side_total
    fits = capacity_bytes is None or total <= capacity_bytes
    return FootprintReport(total, per, main_total, side_total, fits)


@dataclass
class OccupancyTracker:
    """Time-stepped occupancy accounting over one subgraph's regions.

    Models the consumption-centric steady state: each tensor's resident
    rows grow as rows are produced (or streamed from DRAM) and are capped
    at the region allocation ``x`` — the eviction scheme frees any row all
    consumers are past, so a tensor never holds more than its allocation.
    Driven step-by-step by the trace simulator (:mod:`repro_torch.sim`), which
    records ``resident_bytes`` per step and ``peak_bytes`` per subgraph;
    the peak is by construction bounded by the analytical footprint
    (:func:`subgraph_footprint`), and the cross-validation tests pin that.
    """

    caps_rows: Dict[int, int]          # region allocation x, in rows
    line_bytes: Dict[int, int]
    filled: Dict[int, int] = field(default_factory=dict)
    peak_bytes: int = 0

    @classmethod
    def from_schedule(cls, g: Graph,
                      sched: SubgraphSchedule) -> "OccupancyTracker":
        return cls(
            caps_rows={t: ts.x for t, ts in sched.tensors.items()},
            line_bytes={t: g.nodes[t].line_bytes for t in sched.tensors},
        )

    def advance(self, produced: Mapping[int, int]) -> int:
        """Account ``produced`` rows per tensor; returns bytes now resident."""
        for t, rows in produced.items():
            self.filled[t] = self.filled.get(t, 0) + rows
        occ = self.resident_bytes()
        self.peak_bytes = max(self.peak_bytes, occ)
        return occ

    def resident_bytes(self) -> int:
        return sum(
            min(rows, self.caps_rows.get(t, rows)) * self.line_bytes.get(t, 0)
            for t, rows in self.filled.items()
        )

    def resident_by_tensor(self) -> Dict[int, int]:
        """Per-tensor resident bytes (sums exactly to ``resident_bytes`` —
        the trace v3 ``occ_tensors`` timeline source)."""
        return {
            t: min(rows, self.caps_rows.get(t, rows))
            * self.line_bytes.get(t, 0)
            for t, rows in self.filled.items()
        }


def build_region_table(
    g: Graph,
    nodes: Set[int],
    capacity_bytes: int,
    max_regions: int = 64,
    out_tile: int = 1,
    schedule: Optional[SubgraphSchedule] = None,
) -> RegionTable:
    """Compile-time layout: allocate MAIN (+SIDE) regions for every tensor.

    ``schedule`` reuses an already-derived schedule (as
    :func:`subgraph_footprint` does) instead of re-deriving it.
    """
    sched = schedule or derive_schedule(g, nodes, out_tile=out_tile)
    table = RegionTable(capacity_bytes, max_regions)
    for t in sorted(sched.tensors):
        ts = sched.tensors[t]
        table.allocate(t, ts.x * g.nodes[t].line_bytes, "MAIN")
    return table
