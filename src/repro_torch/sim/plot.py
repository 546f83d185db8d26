"""Bandwidth-over-time plotting for traces (``trace --plot out.png``).

matplotlib is an *optional* dependency: :func:`plot_status` answers
"could we plot?" without importing anything heavy, and :func:`plot_bandwidth` raises a friendly
``RuntimeError`` (the CLI turns it into an exit-2 message) when the
library is absent.  Nothing else in the package imports matplotlib, so
every other subcommand works on a matplotlib-free install.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

__all__ = ["plot_status", "plot_bandwidth"]


def plot_status() -> Tuple[bool, str]:
    """(available, reason-or-version) without rendering anything."""
    try:
        import matplotlib
    except ImportError as err:
        return False, (
            "trace --plot needs the optional matplotlib dependency "
            f"(pip install matplotlib): {err}")
    return True, f"matplotlib {matplotlib.__version__}"


def _series(trace: Any, bins: int) -> Tuple[
        List[float], List[float], List[float], List[float]]:
    """Resample the step timeline into ``bins`` equal time buckets.

    Returns (t_ms, dram_gbps, noc_gbps, occ_mb): bucket DRAM/NoC
    bandwidth is bucket bytes over bucket time; occupancy is the last
    step's total (act + weight) resident bytes in the bucket.
    """
    total_cycles = trace.total_cycles
    freq = trace.acc.freq_hz
    n = max(1, bins)
    width = total_cycles / n if total_cycles > 0 else 1.0
    dram = [0.0] * n
    noc = [0.0] * n
    occ = [0.0] * n
    occ_t = [-1.0] * n
    for s in trace.steps:
        # apportion a step's bytes over the buckets its duration spans
        b0 = min(n - 1, int(s.t_cycles / width))
        b1 = min(n - 1, int((s.t_cycles + s.cycles) / width)) if s.cycles \
            else b0
        span = b1 - b0 + 1
        for b in range(b0, b1 + 1):
            dram[b] += s.dram_bytes / span
            noc[b] += s.noc_bytes / span
        if s.t_cycles >= occ_t[b1]:
            occ_t[b1] = s.t_cycles
            occ[b1] = float(s.occ_act + s.occ_w)
    # carry occupancy forward through empty buckets
    last = 0.0
    for b in range(n):
        if occ_t[b] < 0:
            occ[b] = last
        last = occ[b]
    t_ms = [(b + 0.5) * width / freq * 1e3 for b in range(n)]
    secs = width / freq
    dram_gbps = [v / secs / 1e9 for v in dram]
    noc_gbps = [v / secs / 1e9 for v in noc]
    occ_mb = [v / 1e6 for v in occ]
    return t_ms, dram_gbps, noc_gbps, occ_mb


def plot_bandwidth(trace: Any, path: str, bins: int = 256,
                   title: Optional[str] = None) -> None:
    """Render DRAM/NoC bandwidth (and buffer occupancy) over time to
    ``path`` (format from the extension; Agg backend, no display)."""
    ok, why = plot_status()
    if not ok:
        raise RuntimeError(why)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t_ms, dram_gbps, noc_gbps, occ_mb = _series(trace, bins)
    prof = trace.bandwidth_profile()
    fig, (ax, ax2) = plt.subplots(
        2, 1, sharex=True, figsize=(10, 6),
        gridspec_kw={"height_ratios": [3, 1]})
    ax.step(t_ms, dram_gbps, where="mid", label="DRAM", lw=1.2)
    if any(noc_gbps):
        ax.step(t_ms, noc_gbps, where="mid", label="NoC broadcast", lw=1.0)
    for name, val, style in (
            ("p95", prof.percentiles["p95"] / 1e9, ":"),
            ("sustained", prof.sustained / 1e9, "--")):
        ax.axhline(val, ls=style, lw=0.8, color="gray")
        ax.annotate(f"{name} {val:.2f}", xy=(t_ms[-1], val),
                    fontsize=7, color="gray",
                    ha="right", va="bottom")
    ax.set_ylabel("bandwidth (GB/s)")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(title or f"{trace.graph_name}: bandwidth over time "
                          f"({len(trace.steps)} steps)")
    ax2.step(t_ms, occ_mb, where="mid", color="tab:green", lw=1.0)
    ax2.set_ylabel("occupancy (MB)")
    ax2.set_xlabel("time (ms)")
    fig.tight_layout()
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
