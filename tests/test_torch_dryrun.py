"""The port's dry run (``repro_torch.launch.dryrun``) and the mesh faults
it needed repaired, on the CPU.

Every fake world runs in a subprocess of its own (torch's ``fake``
process-group backend, ``FakeTensorMode``, ``--device cpu`` tensors, a
120 s timeout); no process group is ever made in the pytest process.

* ROADMAP §C.1: ``attention_apply`` forward and backward where the model
  axis shards the heads but not the kv heads (tinyllama, glm4, granite,
  jamba at d_model 256, x ``[16, 64, 256]`` data-sharded, the train
  rules) on fake (16, 16) and (1, 8) worlds; and its values on (1, 8) and
  (2, 2) ``gloo`` worlds against the same layer without a mesh.
* ROADMAP §C.2: ``mlstm_apply`` forward and backward at xlstm-350m's full
  width, x ``[16, 512, 1024]``, on a fake (16, 16) world; and the same
  for ``slstm_apply``, whose gate columns split into heads the model axis
  does not divide (§C.3).
* ``shard`` replicates a dim its mesh axis does not divide.
* A sharded train step whose backward runs on a thread of its own (as
  autograd runs a CUDA tensor's) recomputes its rematerialized periods
  under the forward's mesh (xlstm and arctic cut to 1-4 layers at
  d_model 256, real tensors on a fake (16, 16) world).
* The decode step under a mesh (new with the dry run): a prefill and two
  serve steps of the tinyllama smoke config on a (2, 2) ``gloo`` world
  with its caches placed by ``cache_axes`` under the decode rules, against
  the same steps without a mesh.
* ``lower_cell`` rows of train, prefill and decode cells (2-layer
  tinyllama, 1-layer whisper) on a fake 256-rank world carry the
  reference's keys, counted per device; ``lower_cell`` without a fake
  world says what it needs.
* The CLI: the port of ``tests/test_multidevice.py::
  test_dryrun_cli_multi_pod_cell`` (xlstm-350m decode_32k on the 512-rank
  world), and ``--device cuda`` without a GPU exits 2 (dry run and
  hillclimb).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.parallel.sharding import even_placements  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TIMEOUT = 120

C1_ARCHS = ["tinyllama-1.1b", "glm4-9b", "granite-3-8b", "jamba-v0.1-52b"]


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def start(*argv: str) -> subprocess.Popen:
    """A fresh interpreter running ``argv`` (the file's independent fake
    worlds start at once, so that its wall time is their longest)."""
    return subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(),
                            cwd=ROOT)


def finish(proc: subprocess.Popen) -> str:
    """``proc``'s standard output, once it has exited 0 within
    :data:`TIMEOUT` seconds."""
    try:
        stdout, stderr = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    return stdout


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# §C.1, §C.2, §C.3 on fake worlds
# ---------------------------------------------------------------------------

FAKE_LAYERS = textwrap.dedent('''
    import json, math, sys
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import logical_sharding, mesh_context

    torch.set_num_threads(1)
    shape, cases = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    mesh = init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("data", "model"))
    INIT = {"attn": L.attention_init, "mlstm": L.mlstm_init,
            "slstm": L.slstm_init}

    def run(layer, arch, d_model, B, S):
        cfg = get_config(arch)
        if d_model:
            cfg = cfg.with_(d_model=d_model)
        with FakeTensorMode(), mesh_context(mesh, rules_for(cfg, "train")):
            p = INIT[layer](torch.Generator(), cfg)
            vals = {k: distribute_tensor(v.value, mesh,
                                         logical_sharding(v.axes))
                    .requires_grad_() for k, v in p.items()
                    if isinstance(v, L.Param)}
            vals.update({k: {"scale": distribute_tensor(
                v["scale"].value, mesh, logical_sharding(v["scale"].axes))}
                for k, v in p.items() if isinstance(v, dict)})
            x = distribute_tensor(torch.empty(B, S, cfg.d_model), mesh,
                                  logical_sharding(("batch", None, None))
                                  ).requires_grad_()
            with implicit_replication():
                if layer == "attn":
                    pos = torch.arange(S)[None].expand(B, S)
                    out, _ = L.attention_apply(vals, cfg, x, pos,
                                               fresh=True)
                elif layer == "mlstm":
                    out, _ = L.mlstm_apply(vals, cfg, x)
                else:
                    out, _ = L.slstm_apply(vals, cfg, x)
                out.float().sum().backward()
            return [list(out.shape), list(x.grad.shape)]

    res = {}
    for c in cases:
        try:
            res[c["id"]] = {"ok": run(c["layer"], c["arch"], c["d_model"],
                                      c["B"], c["S"])}
        except Exception as e:
            res[c["id"]] = {"error": f"{type(e).__name__}: {e}"[:600]}
    print(json.dumps(res))
''')

REMAT_THREAD = textwrap.dedent('''
    import json, threading
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import lm_loss
    from repro_torch.models.layers import tree_map
    from repro_torch.parallel.sharding import mesh_context

    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    mesh = init_device_mesh("cpu", (16, 16),
                            mesh_dim_names=("data", "model"))
    out = {}
    for arch, over in (
            ("xlstm-350m", {"n_layers": 4, "d_model": 256}),
            ("arctic-480b", {"n_layers": 1, "d_model": 256, "d_ff": 512,
                             "d_ff_expert": 256})):
        cfg = get_config(arch).with_(**over)
        with mesh_context(mesh, rules_for(cfg, "train")):
            _, args = dryrun.cell_step(
                cfg, ShapeSpec("t", 64, 16, "train"), mesh, "cpu")
            values, batch = args[0], args[2]
            leaves = []
            tree_map(leaves.append, values)
            live = [p.detach().requires_grad_(True) for p in leaves]
            it = iter(live)
            with implicit_replication():
                loss, _ = lm_loss(tree_map(lambda _: next(it), values), cfg,
                                  batch)
        err = []

        def backward():  # no mesh_context on this thread
            try:
                with implicit_replication():
                    torch.autograd.grad(loss, live, allow_unused=True)
            except Exception as e:
                err.append(f"{type(e).__name__}: {e}"[:300])

        t = threading.Thread(target=backward)
        t.start()
        t.join()
        out[arch] = err[0] if err else "ok"
    print(json.dumps(out))
''')

FAKE_CASES = {
    "16x16": [16, 16],
    "1x8": [1, 8],
}


def _c1_cases():
    return [{"id": arch, "layer": "attn", "arch": arch, "d_model": 256,
             "B": 16, "S": 64} for arch in C1_ARCHS]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every fake world of this file, started together: each mesh's layer
    cases (§C.1 on both meshes, §C.2 and §C.3 on (16, 16)), the
    ``lower_cell`` rows, and the CLI's multi-pod cell."""
    xl = [{"id": f"xlstm-{layer}", "layer": layer, "arch": "xlstm-350m",
           "d_model": None, "B": 16, "S": 512}
          for layer in ("mlstm", "slstm")]
    out = tmp_path_factory.mktemp("dryrun")
    procs = {name: start("-c", FAKE_LAYERS, json.dumps(shape), json.dumps(
        _c1_cases() + (xl if name == "16x16" else [])))
        for name, shape in FAKE_CASES.items()}
    procs["cells"] = start("-c", CELLS)
    procs["remat"] = start("-c", REMAT_THREAD)
    procs["cli"] = start(
        "-m", "repro_torch.launch.dryrun", "--device", "cpu", "--arch",
        "xlstm-350m", "--shape", "decode_32k", "--mesh", "multi", "--out",
        str(out))
    return procs, out


@pytest.fixture(scope="module")
def fake_layers(worlds):
    return {name: last_json(finish(worlds[0][name])) for name in FAKE_CASES}


@pytest.mark.parametrize("mesh", sorted(FAKE_CASES))
@pytest.mark.parametrize("arch", C1_ARCHS)
def test_c1_attention_runs_where_the_model_axis_splits_only_the_heads(
        fake_layers, mesh, arch):
    got = fake_layers[mesh][arch]
    assert "error" not in got, got
    assert got["ok"] == [[16, 64, 256], [16, 64, 256]]


@pytest.mark.parametrize("layer", ["mlstm", "slstm"])
def test_c2_xlstm_mixers_run_at_full_width_on_16x16(fake_layers, layer):
    got = fake_layers["16x16"][f"xlstm-{layer}"]
    assert "error" not in got, got
    assert got["ok"] == [[16, 512, 1024], [16, 512, 1024]]


@pytest.mark.parametrize("arch", ["xlstm-350m", "arctic-480b"])
def test_remat_recompute_on_another_thread_keeps_the_mesh(worlds, arch):
    """A sharded train step (real tensors, cut to 1-4 layers at d_model
    256, a fake (16, 16) world) whose backward runs on a thread of its
    own, as autograd runs a CUDA tensor's: the rematerialized periods
    recompute under the forward's mesh and rules.  (Without them the
    recompute's ``shard`` calls placed nothing: sLSTM's gate split raised
    and the MoE's recompute saved other tensors than its forward.)"""
    got = last_json(finish(worlds[0]["remat"]))
    assert got[arch] == "ok", got


class _Mesh:
    def __init__(self, *sizes):
        self.sizes = sizes

    def size(self, i):
        return self.sizes[i]


def test_shard_replicates_a_dim_its_axis_does_not_divide():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Mesh(2, 16)
    # heads 4 over a 16-wide model axis: replicated; batch 8 over data 2
    assert even_placements((Shard(0), Shard(2)), (8, 64, 4, 8), mesh) == \
        (Shard(0), Replicate())
    # one tensor dim over both axes: 32 splits 2 x 16 ways, 24 only 2
    assert even_placements((Shard(0), Shard(0)), (32, 5), mesh) == \
        (Shard(0), Shard(0))
    assert even_placements((Shard(0), Shard(0)), (24, 5), mesh) == \
        (Shard(0), Replicate())
    assert even_placements((Replicate(), Shard(1)), (3, 48), mesh) == \
        (Replicate(), Shard(1))


# ---------------------------------------------------------------------------
# values on gloo worlds: §C.1's attention and the decode step
# ---------------------------------------------------------------------------

GLOO = textwrap.dedent('''
    import json, os, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def case_attention(rank, mesh, a):
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import rules_for
        from repro_torch.models import layers as L
        from repro_torch.parallel.sharding import (logical_sharding,
                                                   mesh_context)

        cfg = get_config(a["arch"]).with_(d_model=256)
        p = L.attention_init(torch.Generator().manual_seed(0), cfg)
        x0 = torch.randn(16, 64, 256, generator=torch.Generator()
                         .manual_seed(1))
        pos = torch.arange(64)[None].expand(16, 64)
        # without a mesh
        vals = {k: v.value.clone().requires_grad_() for k, v in p.items()}
        x = x0.clone().requires_grad_()
        out, _ = L.attention_apply(vals, cfg, x, pos, fresh=True)
        out.sum().backward()
        want = [out.detach(), x.grad] + [vals[k].grad for k in sorted(vals)]
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with mesh_context(mesh, rules_for(cfg, "train")), \
                implicit_replication():
            dvals = {k: distribute_tensor(v.value, mesh,
                                          logical_sharding(v.axes))
                     .requires_grad_() for k, v in p.items()}
            dx = distribute_tensor(x0, mesh, logical_sharding(
                ("batch", None, None))).requires_grad_()
            out, _ = L.attention_apply(dvals, cfg, dx, pos, fresh=True)
            out.sum().backward()
            got = [out.full_tensor(), dx.grad.full_tensor()] + [
                dvals[k].grad.full_tensor() for k in sorted(dvals)]
        return {"rel": [rel(g, w) for g, w in zip(got, want)],
                "placements": str(dvals["wq"].placements)}

    def case_decode(rank, mesh, a):
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import ShapeSpec
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import rules_for
        from repro_torch.models import init_caches, lm_apply, lm_init
        from repro_torch.models.layers import param_values
        from repro_torch.parallel.sharding import mesh_context

        cfg = get_config("tinyllama-1.1b", smoke=True)
        B, T = 4, 16
        toks = torch.randint(0, cfg.vocab, (B, T + 2), generator=torch
                             .Generator().manual_seed(2), dtype=torch.int32)
        params = param_values(lm_init(cfg, torch.Generator().manual_seed(0)))

        def steps(step, values, caches):
            out = []
            for t in range(T + 2):
                pos = torch.full((B, 1), t, dtype=torch.int32)
                logits = step(values, caches, toks[:, t:t + 1], pos)[0]
                out.append(logits.full_tensor() if hasattr(
                    logits, "full_tensor") else logits)
            return out[T - 1:]

        serve = torch.no_grad()(dryrun.make_serve_step(cfg))
        f32 = torch.float32
        want = steps(serve, params, init_caches(cfg, B, T + 2, f32))
        with torch.no_grad():
            caches = init_caches(cfg, B, T, torch.bfloat16)
            want.append(lm_apply(params, cfg, toks[:, :T], caches=caches,
                                 prefill=True)[0][:, -1])
        from torch.distributed.tensor.experimental import \
            implicit_replication
        # the plain tokens and positions read as replicated, as the dry
        # run's trace_step reads them
        with torch.no_grad(), mesh_context(mesh, rules_for(
                cfg, "decode")), implicit_replication():
            step, args = dryrun.cell_step(
                cfg, ShapeSpec("d", T + 2, B, "decode"), mesh, "cpu",
                generator=torch.Generator().manual_seed(0), cache_dtype=f32)
            got = steps(step, args[0], args[1])
            prefill = dryrun.make_prefill_step(cfg, T, mesh, "cpu")
            got.append(prefill(args[0], {"tokens": toks[:, :T]})[0]
                       .full_tensor())
        return {"rel": [rel(g, w) for g, w in zip(got, want)],
                "cache": str(args[1]["scan"]["p0"]["k"].placements)}

    def main(rank, world, d, case, a):
        from torch.distributed.device_mesh import init_device_mesh
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            d, "rendezvous"), rank=rank, world_size=world)
        try:
            mesh = init_device_mesh("cpu", tuple(a["shape"]),
                                    mesh_dim_names=("data", "model"))
            res = globals()["case_" + case](rank, mesh, a)
            if rank == 0:
                with open(os.path.join(d, "out.json"), "w") as f:
                    json.dump(res, f)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        d, case = sys.argv[1], sys.argv[2]
        with open(os.path.join(d, "args.json")) as f:
            a = json.load(f)
        world = 1
        for s in a["shape"]:
            world *= s
        mp.spawn(main, args=(world, d, case, a), nprocs=world)
''')


def spawn(d, case: str, **args) -> dict:
    d.mkdir(parents=True, exist_ok=True)
    (d / "worker.py").write_text(GLOO)
    (d / "args.json").write_text(json.dumps(args))
    out = subprocess.run([sys.executable, str(d / "worker.py"), str(d), case],
                         capture_output=True, text=True, timeout=TIMEOUT,
                         env=_env(), cwd=ROOT)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("shape", [[1, 8], [2, 2]])
def test_c1_attention_values_equal_the_unsharded_layer(tmp_path, shape):
    res = spawn(tmp_path, "attention", arch="tinyllama-1.1b", shape=shape)
    # output, dx, then the weights' gradients
    assert max(res["rel"]) < 1e-5, res


def test_decode_step_under_a_mesh_equals_the_unsharded_steps(tmp_path):
    """The prompt and two more tokens through the serve step one at a
    time (the last prompt position's logits and the next two) over an
    fp32 cache, and a prefill into a bf16 ring the prompt fills, each on
    the mesh against the same without one.  (Over a bf16 cache the
    sequence-sharded decode differs by ~3e-3 relative: the attention's
    sums over the key shards are bf16 partial sums, each rounded before
    they are added.)"""
    res = spawn(tmp_path, "decode", shape=[2, 2])
    # the stacked cache's sequence is sharded over the model axis (seq_kv)
    assert "Shard(dim=2)" in res["cache"], res
    assert len(res["rel"]) == 4 and max(res["rel"]) < 1e-5, res


# ---------------------------------------------------------------------------
# lower_cell and the CLI
# ---------------------------------------------------------------------------

# the keys of the reference's rows (its RooflineReport.row() and
# lower_cell's additions)
REF_ROW_KEYS = {
    "arch", "shape", "mesh", "devices", "hlo_gflops", "hlo_gbytes",
    "coll_gbytes", "t_compute_ms", "t_memory_ms", "t_collective_ms",
    "bottleneck", "model_gflops_global", "flops_util", "roofline_frac",
    "coll_breakdown", "bytes_per_device", "lower_s", "compile_s", "kind",
    "rules", "param_count", "active_param_count", "microbatches",
    "scan_correction_flops", "scan_correction_bytes", "coll_multiplier",
    "layout", "temp_size_in_bytes", "argument_size_in_bytes"}

CELLS = textwrap.dedent('''
    import json
    import torch
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    rows = {}
    with dryrun.fake_world(256):
        for arch, shape, over in (
                ("tinyllama-1.1b", "train_4k", {"n_layers": 2}),
                ("tinyllama-1.1b", "prefill_32k", {"n_layers": 2}),
                ("tinyllama-1.1b", "decode_32k", {"n_layers": 2}),
                ("whisper-base", "decode_32k",
                 {"n_layers": 1, "n_enc_layers": 1})):
            rows[f"{arch}/{shape}"] = dryrun.lower_cell(
                arch, shape, False, cfg_overrides=over, verbose=False,
                device="cpu")
    print(json.dumps(rows, default=str))
''')


@pytest.fixture(scope="module")
def cell_rows(worlds):
    return last_json(finish(worlds[0]["cells"]))


@pytest.mark.parametrize("cell", [
    "tinyllama-1.1b/train_4k", "tinyllama-1.1b/prefill_32k",
    "tinyllama-1.1b/decode_32k", "whisper-base/decode_32k"])
def test_lower_cell_rows_carry_the_references_keys(cell_rows, cell):
    row = cell_rows[cell]
    assert REF_ROW_KEYS <= set(row), REF_ROW_KEYS - set(row)
    assert row["devices"] == 256 and row["mesh"] == "pod16x16"
    assert row["counted_at"] == "per_device" and row["compile_s"] == 0.0
    assert row["bottleneck"] in ("compute", "memory", "collective")
    assert row["hlo_gflops"] > 0 and row["hlo_gbytes"] > 0
    assert row["coll_gbytes"] > 0 and sum(row["coll_counts"].values()) > 0
    assert 0 < row["argument_size_in_bytes"] <= row["peak_bytes"]
    assert row["temp_size_in_bytes"] + row["argument_size_in_bytes"] == \
        row["peak_bytes"]
    # the CPU route: the kernels' plain versions, no kernel op
    assert row["kernel_calls"] == {}
    assert row["microbatches"] == (2 if row["kind"] == "train" else 1)
    assert row["t_compute_ms"] == pytest.approx(
        row["hlo_gflops"] * 1e9 / roofline.PEAK_FLOPS * 1e3)


def test_lower_cell_needs_its_fake_world():
    with pytest.raises(RuntimeError, match="fake world of 256 ranks"):
        dryrun.lower_cell("tinyllama-1.1b", "train_4k", False,
                          device="cpu")


def test_cli_multi_pod_cell(worlds):
    """``python -m repro_torch.launch.dryrun --device cpu --arch
    xlstm-350m --shape decode_32k --mesh multi --out D``."""
    procs, out = worlds
    assert "dryrun: 1 ok, 0 skipped (documented), 0 failed" in \
        finish(procs["cli"])
    row = json.loads(
        (out / "xlstm-350m__decode_32k__pod2x16x16.json").read_text())
    assert row["devices"] == 512
    assert row["bottleneck"] in ("compute", "memory", "collective")
    assert row["counted_at"] == "per_device"


@pytest.mark.parametrize("module,args", [
    ("dryrun", ["--arch", "tinyllama-1.1b", "--shape", "train_4k"]),
    ("hillclimb", ["--arch", "tinyllama-1.1b", "--shape", "train_4k"])])
def test_cuda_without_a_gpu_exits_2(module, args):
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", *args],
        capture_output=True, text=True, timeout=TIMEOUT, env=_env(),
        cwd=ROOT)
    assert out.returncode == 2, out.stdout + out.stderr
    assert out.stderr.startswith("error: --device cuda needs a CUDA GPU")
    assert out.stdout == ""
