"""`ExploreSpec`: the single, serializable input to every search strategy.

A spec names a workload (a graph in :mod:`repro_torch.core.netlib`), an
:class:`~repro_torch.core.ga.Objective`, an :class:`~repro_torch.core.ga.HWSpace`, a
sample budget, a seed, a strategy name, and that strategy's typed options —
replacing the old string-`mode`/`metric` + ``**ga_kw`` surface.  Specs are
frozen, compare by value, and round-trip losslessly through JSON, so a run
is reproducible from its serialized spec alone.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.cost import AcceleratorConfig
from repro_torch.core.ga import HWSpace, Objective

from .registry import options_class_for


# ---------------------------------------------------------------------------
# per-strategy option blocks (typed replacements for **ga_kw)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GAOptions:
    """Cocco's genetic co-exploration (paper §4.3–4.4)."""

    population: int = 100
    tournament_k: int = 4
    crossover_frac: float = 0.5
    elite: int = 2
    log_populations: bool = False
    # names of registered strategies whose result groups seed the initial
    # population (paper §4.3 benefit 4, "flexible initialization")
    seed_from: Tuple[str, ...] = ()
    # store keys (64-hex, see `repro_torch.api.store.spec_key`) of archived
    # ExploreResults whose groups also seed the initial population — the
    # warm-start path for FULL-budget sweeps from reduced-run artifacts
    # (`--seed-from-store` on the CLI).  Requires a store at run time; the
    # keys are part of the spec, so a warm-started run has its own address.
    seed_from_keys: Tuple[str, ...] = ()


@dataclass(frozen=True)
class GreedyOptions:
    """Halide-style greedy merging (paper §4.2.2)."""

    eval_budget: int = 30_000


@dataclass(frozen=True)
class DPOptions:
    """Irregular-NN DP over depth order (paper §4.2.3) — no knobs."""


@dataclass(frozen=True)
class EnumOptions:
    """Exact state-compression DP over ideals; budgeted (paper §4.2.1)."""

    state_budget: int = 2_000_000


@dataclass(frozen=True)
class SAOptions:
    """Simulated annealing over Cocco's mutation neighbourhood (§4.2.4)."""

    t0: float = 1.0
    t_end: float = 1e-3


@dataclass(frozen=True)
class TwoStepOptions:
    """RS+GA / GS+GA: capacity sampling then partition-only GA (§5.1.3)."""

    sampler: str = "random"          # "random" | "grid"
    capacity_samples: int = 10
    samples_per_capacity: int = 5_000


# ---------------------------------------------------------------------------
# (de)serialization helpers for the core value types
# ---------------------------------------------------------------------------

def acc_to_dict(acc: AcceleratorConfig) -> Dict[str, Any]:
    return asdict(acc)


def acc_from_dict(d: Dict[str, Any]) -> AcceleratorConfig:
    return AcceleratorConfig(**d)


def objective_to_dict(obj: Objective) -> Dict[str, Any]:
    return {"metric": obj.metric, "alpha": obj.alpha}


def objective_from_dict(d: Dict[str, Any]) -> Objective:
    return Objective(metric=d["metric"], alpha=d["alpha"])


def hw_to_dict(hw: HWSpace) -> Dict[str, Any]:
    d = {
        "mode": hw.mode,
        "base": acc_to_dict(hw.base),
        "glb_candidates": list(hw.glb_candidates),
        "wbuf_candidates": list(hw.wbuf_candidates),
        "shared_candidates": list(hw.shared_candidates),
    }
    # written only when the core axis is explored: the default () serializes
    # byte-identically to pre-core-axis specs, so store/zoo addresses
    # (spec_key hashes this dict) of existing artifacts stay valid
    if hw.core_candidates:
        d["core_candidates"] = list(hw.core_candidates)
    return d


def hw_from_dict(d: Dict[str, Any]) -> HWSpace:
    return HWSpace(
        mode=d["mode"],
        base=acc_from_dict(d["base"]),
        glb_candidates=tuple(d["glb_candidates"]),
        wbuf_candidates=tuple(d["wbuf_candidates"]),
        shared_candidates=tuple(d["shared_candidates"]),
        core_candidates=tuple(d.get("core_candidates", ())),
    )


def options_to_dict(options: Any) -> Optional[Dict[str, Any]]:
    return None if options is None else asdict(options)


def options_from_dict(strategy: str, d: Optional[Dict[str, Any]]) -> Any:
    cls = options_class_for(strategy)
    if cls is None:
        if d is not None:
            raise ValueError(
                f"cannot deserialize options for unregistered strategy "
                f"{strategy!r}; call register_strategy first")
        return None
    if d is None:
        return cls()
    kw = dict(d)
    # JSON turns tuples into lists; coerce back for tuple-defaulted fields
    for f in fields(cls):
        if isinstance(f.default, tuple) and isinstance(kw.get(f.name), list):
            kw[f.name] = tuple(kw[f.name])
    return cls(**kw)


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

SPEC_VERSION = 1


@dataclass(frozen=True)
class ExploreSpec:
    """One fully-specified exploration run.

    ``workload`` is a workload URI resolved by
    :func:`repro_torch.api.workloads.build_workload` — ``netlib:<model>`` (a bare
    name aliases here), ``synthetic:<kind>:<n>``,
    ``file:<path>.json``, or any scheme added via
    :func:`~repro_torch.api.workloads.register_workload_scheme` — unless the
    caller passes an explicit graph to :func:`repro_torch.api.run` (then it is a
    free-form label).  ``options`` is the registered strategy's typed option
    dataclass; ``None`` resolves to that strategy's defaults.
    """

    workload: str
    strategy: str = "ga"
    objective: Objective = Objective(metric="energy", alpha=None)
    hw: HWSpace = field(default_factory=HWSpace)
    sample_budget: int = 50_000
    seed: int = 0
    out_tile: int = 1
    options: Any = None

    def __post_init__(self) -> None:
        # Fail malformed workload URIs at spec construction, not mid-search.
        # Scheme-less names stay free-form (netlib aliases / custom-graph
        # labels); anything with a ``:`` must parse under a registered
        # scheme.  Syntax-only: no graph is built, no file is touched.
        from .workloads import validate_workload

        validate_workload(self.workload)
        if self.options is None:
            cls = options_class_for(self.strategy)
            if cls is not None:
                object.__setattr__(self, "options", cls())

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": SPEC_VERSION,
            "workload": self.workload,
            "strategy": self.strategy,
            "objective": objective_to_dict(self.objective),
            "hw": hw_to_dict(self.hw),
            "sample_budget": self.sample_budget,
            "seed": self.seed,
            "out_tile": self.out_tile,
            "options": options_to_dict(self.options),
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExploreSpec":
        return cls(
            workload=d["workload"],
            strategy=d["strategy"],
            objective=objective_from_dict(d["objective"]),
            hw=hw_from_dict(d["hw"]),
            sample_budget=d["sample_budget"],
            seed=d["seed"],
            out_tile=d.get("out_tile", 1),
            options=options_from_dict(d["strategy"], d.get("options")),
        )

    @classmethod
    def from_json(cls, data: str) -> "ExploreSpec":
        return cls.from_dict(json.loads(data))
