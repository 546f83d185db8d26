"""Strategy registry: one namespace under which every search method runs.

A strategy is a callable ``fn(spec, options, graph, ev, **runtime) ->
ExploreResult`` registered under a short name together with its typed
options dataclass.  ``register_strategy`` is open: downstream code can add
new methods and they become visible to ``run``/``compare`` and the CLI
without touching this package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Protocol, runtime_checkable


@runtime_checkable
class Strategy(Protocol):
    """Shape of a registered strategy runner."""

    def __call__(self, spec: Any, options: Any, graph: Any, ev: Any,
                 **runtime: Any) -> Any: ...


@dataclass(frozen=True)
class StrategyEntry:
    name: str
    fn: Callable
    options_cls: Optional[type]


_STRATEGIES: Dict[str, StrategyEntry] = {}


def register_strategy(name: str, options_cls: Optional[type] = None):
    """Decorator: register ``fn`` as strategy ``name``.

    ``options_cls`` is the frozen dataclass of per-strategy knobs; it is
    what ``ExploreSpec.options`` defaults to and what JSON deserialization
    instantiates for this strategy.
    """

    def deco(fn: Callable) -> Callable:
        _STRATEGIES[name] = StrategyEntry(name=name, fn=fn,
                                          options_cls=options_cls)
        return fn

    return deco


def get_strategy(name: str) -> StrategyEntry:
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; registered: {sorted(_STRATEGIES)}"
        ) from None


def list_strategies() -> List[str]:
    return sorted(_STRATEGIES)


def options_class_for(name: str) -> Optional[type]:
    entry = _STRATEGIES.get(name)
    return entry.options_cls if entry else None
