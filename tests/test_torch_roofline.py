"""The port's roofline, report and hillclimb (``repro_torch.launch``)
against the JAX package's, on the CPU.

* The analytic part (per-layer FLOPs and bytes, the scan correction,
  MODEL_FLOPS) equals the reference's exactly on all ten configs and all
  four shapes.
* ``RooflineReport``'s arithmetic on the same counts: each time term times
  its package's rate gives back the same count (the rates are the H100's
  here, the reference's chip's there, within 1e-12 relative: one division
  and one product), the same utilization, the same row keys.
* ``report.py``'s three tables and its hillclimb picks are byte- and
  value-equal to the reference's on a hand-written set of rows with ok,
  skipped and failed cells; ``VARIANTS`` equals the reference's dict
  (read from its source: importing the reference's hillclimb sets
  ``XLA_FLAGS`` for the whole worker process).
* The step counter counts per device: under the ``dp_only`` variant on a
  fake (4, 1) world, per-device FLOPs x 4 equal the FLOPs of the same
  step with no mesh exactly; under the default rules on (2, 2) they are
  at least that (replicated work counts on every rank).  Its collective
  counts equal ``CommDebugMode``'s.  (A subprocess on torch's ``fake``
  backend, 120 s timeout.)
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import report as ref_report  # noqa: E402
from repro.launch import roofline as ref  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import hillclimb, report, roofline  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TIMEOUT = 120

REF_PEAK, REF_HBM, REF_ICI = 197e12, 819e9, 50e9


# ---------------------------------------------------------------------------
# the analytic part, every config x shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_equal_the_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    sp = SHAPES[shape]
    kind, S, B = sp.kind, sp.seq_len, sp.global_batch
    tokens = B if kind == "decode" else S * B
    kv = S if kind == "decode" else S / 2
    specs = cfg.block_specs()
    for idx, spec in enumerate(specs):
        assert roofline.layer_flops(cfg, idx, tokens, kv, kind) == \
            ref.layer_flops(rcfg, idx, tokens, kv, kind), idx
        assert roofline._layer_param_bytes(cfg, idx) == \
            ref._layer_param_bytes(rcfg, idx), idx
        for n in (256, 512):
            assert roofline.layer_bytes(cfg, idx, tokens / n, kind) == \
                ref.layer_bytes(rcfg, idx, tokens / n, kind), idx
        assert roofline._mixer_token_flops(cfg, spec.mixer, S) == \
            ref._mixer_token_flops(rcfg, spec.mixer, S)
        assert roofline._ffn_token_flops(cfg, spec.ffn) == \
            ref._ffn_token_flops(rcfg, spec.ffn)
    for n in (1, 256, 512):
        assert roofline.scan_correction(cfg, kind, S, B, n) == \
            ref.scan_correction(rcfg, kind, S, B, n)
    assert roofline.model_flops_for(cfg, kind, S, B) == \
        ref.model_flops_for(rcfg, kind, S, B)
    assert roofline.model_flops_for(cfg, kind, S, B, 4096) == \
        ref.model_flops_for(rcfg, kind, S, B, 4096)
    for mixer in ("attn", "attn_local", "attn_mla"):
        if mixer != "attn_mla" or cfg.q_lora_rank or cfg.kv_lora_rank:
            assert roofline._mixer_token_flops(cfg, mixer, S) == \
                ref._mixer_token_flops(rcfg, mixer, S)


def test_constants_are_the_h100s():
    from repro_torch.core.h100_adapter import H100_ACC, HBM_BYTES_PER_SEC

    assert roofline.PEAK_FLOPS == pytest.approx(989e12, rel=1e-3)
    assert roofline.PEAK_FLOPS == \
        2 * H100_ACC.macs_per_cycle * H100_ACC.freq_hz
    assert roofline.HBM_BW == HBM_BYTES_PER_SEC == 3.35e12
    assert roofline.LINK_BW == 50e9
    src = open(roofline.__file__).read()
    for tpu in ("197e12", "819e9", "TPU", "v5e", "ICI"):
        assert tpu not in src


# ---------------------------------------------------------------------------
# RooflineReport's arithmetic
# ---------------------------------------------------------------------------

REPORTS = [
    # (flops, bytes, coll, model_flops, devices): compute-, memory- and
    # collective-bound on both packages' rates, and all zero
    (5.0e15, 1.0e12, 1.0e9, 1.1e18, 256),
    (1.0e12, 4.0e12, 1.0e8, 2.0e14, 512),
    (1.0e12, 1.0e9, 6.0e11, 3.0e14, 256),
    (0.0, 0.0, 0.0, 0.0, 256),
]


@pytest.mark.parametrize("flops,nbytes,coll,mf,n", REPORTS)
def test_report_arithmetic_equals_the_reference(flops, nbytes, coll, mf, n):
    kw = dict(arch="tinyllama-1.1b", shape="train_4k", mesh="pod16x16",
              n_devices=n, hlo_flops=flops, hlo_bytes=nbytes,
              coll_bytes=coll, coll_breakdown={"all-reduce": int(coll)},
              model_flops=mf, bytes_per_device=3.0e9)
    got, want = roofline.RooflineReport(**kw), ref.RooflineReport(**kw)
    assert got.t_compute * roofline.PEAK_FLOPS == pytest.approx(
        want.t_compute * REF_PEAK, rel=1e-12, abs=0)
    assert got.t_memory * roofline.HBM_BW == pytest.approx(
        want.t_memory * REF_HBM, rel=1e-12, abs=0)
    assert got.t_collective * roofline.LINK_BW == pytest.approx(
        want.t_collective * REF_ICI, rel=1e-12, abs=0)
    assert got.flops_utilization == want.flops_utilization
    terms = {"compute": got.t_compute, "memory": got.t_memory,
             "collective": got.t_collective}
    assert got.bottleneck == max(terms, key=terms.get)
    bound = max(terms.values())
    assert got.roofline_fraction == (
        mf / n / roofline.PEAK_FLOPS / bound if bound > 0 else 0.0)
    if got.bottleneck == want.bottleneck == "compute":
        assert got.roofline_fraction == pytest.approx(
            want.roofline_fraction, rel=1e-12)
    row, ref_row = got.row(), want.row()
    assert row.keys() == ref_row.keys()
    for k in ("arch", "shape", "mesh", "devices", "hlo_gflops", "hlo_gbytes",
              "coll_gbytes", "model_gflops_global", "flops_util",
              "coll_breakdown", "bytes_per_device"):
        assert row[k] == ref_row[k], k


# ---------------------------------------------------------------------------
# report.py and hillclimb's variants
# ---------------------------------------------------------------------------

def _ok(arch, shape, mesh, kind, frac, tc, tm, tx, gflops, **extra):
    bound = max({"compute": tc, "memory": tm, "collective": tx}.items(),
                key=lambda kv: kv[1])[0]
    return {"arch": arch, "shape": shape, "mesh": mesh, "devices": 256,
            "kind": kind, "hlo_gflops": gflops, "hlo_gbytes": 12.5,
            "coll_gbytes": 3.25, "t_compute_ms": tc, "t_memory_ms": tm,
            "t_collective_ms": tx, "bottleneck": bound,
            "model_gflops_global": 1.0e6, "flops_util": 0.8125,
            "roofline_frac": frac, "coll_breakdown": {},
            "bytes_per_device": 2.0e9, "lower_s": 12.3, "compile_s": 0.0,
            "temp_size_in_bytes": 3 * 2**30,
            "argument_size_in_bytes": 5 * 2**29, **extra}


ROWS = [
    _ok("tinyllama-1.1b", "train_4k", "pod16x16", "train", 0.41, 120.5,
        80.25, 60.0, 90000.0),
    _ok("tinyllama-1.1b", "decode_32k", "pod16x16", "decode", 0.002, 0.5,
        3.75, 3.0, 2.0),
    _ok("glm4-9b", "prefill_32k", "pod16x16", "prefill", 0.3, 400.0, 100.0,
        900.0, 40000.0),
    _ok("glm4-9b", "train_4k", "pod2x16x16", "train", 0.5, 60.0, 30.0,
        20.0, 5000.0, compile_s=7.6),
    _ok("xlstm-350m", "decode_32k", "pod2x16x16", "decode", 0.01, 0.1,
        0.9, 0.2, 1.5),
    {"arch": "tinyllama-1.1b", "shape": "long_500k", "mesh": "pod16x16",
     "skipped": "N/A: pure full-attention arch"},
    {"arch": "arctic-480b", "shape": "train_4k", "mesh": "pod16x16",
     "error": "RuntimeError: boom", "traceback": "..."},
    {"arch": "arctic-480b", "shape": "train_4k", "mesh": "pod2x16x16",
     "error": "RuntimeError: boom", "traceback": "..."},
]


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_report_tables_are_the_references(mesh):
    assert report.dryrun_table(ROWS, mesh) == \
        ref_report.dryrun_table(ROWS, mesh)
    assert report.roofline_table(ROWS, mesh) == \
        ref_report.roofline_table(ROWS, mesh)
    assert report.roofline_table(ROWS) == ref_report.roofline_table(ROWS)
    assert report.fmt_bytes(None) == ref_report.fmt_bytes(None) == "-"


def test_hillclimb_picks_are_the_references():
    got, want = report.pick_hillclimb(ROWS), ref_report.pick_hillclimb(ROWS)
    assert got == want
    assert [p["why"] for p in got] == [
        "worst roofline fraction", "most collective-bound",
        "most representative of the technique"]
    assert report.pick_hillclimb([]) == ref_report.pick_hillclimb([]) == []


def test_report_main_prints_the_references_bytes(tmp_path, monkeypatch):
    for i, row in enumerate(ROWS):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(row))
    outs = []
    for mod in (report, ref_report):
        monkeypatch.setattr(sys, "argv", ["report", "--dir", str(tmp_path)])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "| glm4-9b | train_4k | ok |" in outs[0]
    assert report.load(str(tmp_path)) == ref_report.load(str(tmp_path))


def _reference_variants() -> dict:
    path = os.path.join(SRC, "repro", "launch", "hillclimb.py")
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and node.target.id == "VARIANTS":
            return ast.literal_eval(node.value)
    raise AssertionError("VARIANTS not found in the reference")


def test_variants_equal_the_references():
    assert hillclimb.VARIANTS == _reference_variants()


def test_hillclimb_summarize_prints_rows_and_failures(capsys):
    rows = [dict(ROWS[0], variant="baseline"),
            {"arch": "a", "shape": "s", "variant": "sp",
             "error": "RuntimeError: boom"}]
    hillclimb.summarize(rows)
    out = capsys.readouterr().out
    assert "baseline" in out and "120.5" in out
    assert "sp               FAILED: RuntimeError: boom" in out


# ---------------------------------------------------------------------------
# per-device counts on fake worlds
# ---------------------------------------------------------------------------

COUNTS = textwrap.dedent('''
    import json, sys
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.mesh import rules_for
    from repro_torch.parallel.sharding import mesh_context

    torch.set_num_threads(1)
    cfg = get_config("tinyllama-1.1b", smoke=True)
    shape = ShapeSpec("t", 32, 8, "train")
    out = {}
    with FakeTensorMode():
        step, args = dryrun.cell_step(cfg, shape, None, "cpu", 2)
        out["no_mesh"] = dryrun.trace_step(step, args)[0].flops
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    for name, mesh_shape, over in (
            ("dp_only", (4, 1), hillclimb.VARIANTS["dp_only"]["rules"]),
            ("default", (2, 2), None)):
        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode(), mesh_context(mesh, rules_for(cfg, "train",
                                                            over)):
            step, args = dryrun.cell_step(cfg, shape, mesh, "cpu", 2)
            with CommDebugMode() as comm:
                c, peak = dryrun.trace_step(step, args)
        out[name] = {"flops": c.flops, "coll": c.coll_counts,
                     "comm": {str(k).split(".")[-1]: v for k, v in
                              comm.get_comm_counts().items()},
                     "bytes": c.bytes, "peak": peak,
                     "args": dryrun.argument_bytes(args)}
    print(json.dumps(out))
''')


def run_script(script: str, *args: str, timeout: int = TIMEOUT) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", script, *args],
                         capture_output=True, text=True, timeout=timeout,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def counts():
    return run_script(COUNTS)


def test_data_parallel_flops_per_device_are_a_quarter(counts):
    assert counts["no_mesh"] > 0
    assert counts["dp_only"]["flops"] * 4 == counts["no_mesh"]


def test_default_rules_count_replicated_work_on_every_rank(counts):
    assert counts["default"]["flops"] * 4 >= counts["no_mesh"]
    assert counts["default"]["flops"] < counts["no_mesh"]


_KIND = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all"}


@pytest.mark.parametrize("variant", ["dp_only", "default"])
def test_collective_counts_equal_comm_debug_modes(counts, variant):
    c = counts[variant]
    assert c["coll"], "a sharded step issues collectives"
    assert c["coll"] == {_KIND[k]: v for k, v in c["comm"].items()}
    assert 0 < c["args"] <= c["peak"] and c["bytes"] > 0
