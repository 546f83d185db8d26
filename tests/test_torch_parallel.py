"""The port's meshes, sharding rules, gradient compression, pipeline and
sharded train step (``repro_torch.parallel``, ``repro_torch.launch.mesh``)
against the JAX package, on the CPU.

Without a process group: ``spec_for`` and ``rules_for`` equal the
reference's on the cases of ``tests/test_sharding.py``, and the int8 /
bf16 compression of ``tests/test_collectives.py`` equals it bit for bit.

With 2-4 ``gloo`` ranks (``torch.multiprocessing`` in a subprocess, the
rendezvous a ``file://`` in the test's directory, each spawn under a 120 s
timeout):

* one fp32 train step of the tinyllama and jamba smoke configs on a
  (data 2, model 2) mesh: the loss within 1e-5 and each parameter within
  1e-4 (relative to its norm) of the port's unsharded step, and within
  the reference's own bounds (loss 1e-3, worst parameter 5e-3) of the JAX
  single-device step;
* ``pipeline_apply`` with P 4, M 8: within 1e-5 of the sequential loop
  and of the JAX ``pipeline_apply`` (run with 4 XLA host devices);
* a checkpoint saved sharded 4 ways restores onto a 2-rank mesh through
  ``reshard_to``;
* ``python -m torch.distributed.run --nproc-per-node 4 -m
  repro_torch.launch.train --model-parallel 2``: the 1-process run's
  losses within 1e-5.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.mesh import rules_for as ref_rules_for  # noqa: E402
from repro.models import lm_init as jax_lm_init  # noqa: E402
from repro.models import param_values as jax_param_values  # noqa: E402
from repro.parallel import collectives as ref_coll  # noqa: E402
from repro.parallel.sharding import DEFAULT_RULES as REF_RULES  # noqa: E402
from repro.parallel.sharding import spec_for as ref_spec_for  # noqa: E402
from repro.train import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train import adamw_init as jax_adamw_init  # noqa: E402
from repro.train.trainstep import make_train_step as jax_train_step  # noqa: E402
from repro_torch.bridge import lm_params_from_reference  # noqa: E402
from repro_torch.checkpoint.io import keypath_items  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import rules_for  # noqa: E402
from repro_torch.models import cache_axes, init_caches, lm_init  # noqa: E402
from repro_torch.models.layers import is_param, tree_map  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_bubble_fraction  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    DEFAULT_RULES,
    mesh_context,
    placements_for,
    shard,
    spec_for,
)
from repro_torch.train import AdamWConfig, adamw_init, make_train_step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
SPAWN_TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs files on parallel workers: this file's small torch
    work takes two intra-op threads, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ref_mesh(shape=(2, 2), names=("data", "model")):
    devs = np.array(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, names)


# ---------------------------------------------------------------------------
# rules and specs (no process group): tests/test_sharding.py's cases
# ---------------------------------------------------------------------------

def test_spec_resolution_and_pod_dropping():
    spec = spec_for(("batch", None, "heads"), DEFAULT_RULES,
                    ("data", "model"))
    assert spec == ("data", None, "model")
    assert spec == tuple(ref_spec_for(("batch", None, "heads"), REF_RULES,
                                      ref_mesh()))


def test_duplicate_mesh_axis_suppressed():
    spec = spec_for(("heads", "ff"), DEFAULT_RULES, ("data", "model"))
    assert spec == ("model", None)
    assert spec == tuple(ref_spec_for(("heads", "ff"), REF_RULES,
                                      ref_mesh()))


def test_multi_pod_batch_spec():
    names = ("pod", "data", "model")
    spec = spec_for(("batch", "seq"), DEFAULT_RULES, names)
    assert spec == (("pod", "data"), None)
    assert spec == tuple(ref_spec_for(("batch", "seq"), REF_RULES,
                                      ref_mesh((2, 2, 2), names)))


def test_rules_disable_unshardable_axes():
    rules = rules_for(get_config("xlstm-350m"), "train")
    assert rules["heads"] is None and rules["kv_heads"] is None
    rules2 = rules_for(get_config("glm4-9b"), "train")
    assert rules2["kv_heads"] is None and rules2["heads"] == "model"
    assert DEFAULT_RULES == REF_RULES
    assert list(ARCHS) == list(REF_ARCHS)
    for arch in ARCHS:
        for kind in ("train", "prefill", "decode", "decode_long"):
            for smoke in (False, True):
                assert rules_for(get_config(arch, smoke), kind) == \
                    ref_rules_for(jax_get_config(arch, smoke), kind), \
                    (arch, kind, smoke)


def test_decode_rules_shard_cache_sequence():
    cfg = get_config("glm4-9b")
    rules = rules_for(cfg, "decode")
    assert rules["seq_kv"] == "model"
    long_rules = rules_for(cfg, "decode_long", {"embed": "data"})
    assert long_rules["seq_kv"] == ("data", "model")
    assert long_rules["batch"] is None
    assert long_rules == ref_rules_for(jax_get_config("glm4-9b"),
                                       "decode_long", {"embed": "data"})


def test_param_axes_align_with_tree():
    """Every parameter's logical axes match its rank and the reference's
    axes at the same key path, and resolve to the reference's specs on a
    (data, model) mesh."""
    for arch in ("tinyllama-1.1b", "jamba-v0.1-52b", "deepseek-v2-236b",
                 "xlstm-350m"):
        cfg = get_config(arch, smoke=True)
        params = lm_init(cfg, torch.Generator().manual_seed(0))
        ref = jax.eval_shape(lambda c=jax_get_config(arch, smoke=True):
                             jax_lm_init(jax.random.PRNGKey(0), c))
        ref_axes = {jax.tree_util.keystr(p): leaf.axes for p, leaf in
                    jax.tree_util.tree_flatten_with_path(
                        ref, is_leaf=lambda x: hasattr(x, "axes"))[0]}
        got = dict(keypath_items(tree_map(lambda p: p, params)))
        assert set(got) == set(ref_axes), arch
        rules = rules_for(cfg, "train")
        for key, p in got.items():
            assert is_param(p)
            assert len(p.axes) == p.value.dim(), (key, p.axes)
            assert p.axes == ref_axes[key], key
            assert spec_for(p.axes, rules, ("data", "model")) == tuple(
                ref_spec_for(ref_axes[key], ref_rules_for(
                    jax_get_config(arch, smoke=True), "train"), ref_mesh()))


def _dict_leaves(tree, path=""):
    """(path, leaf) of a tree of nested dicts, anything else a leaf."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    return [item for k in sorted(tree)
            for item in _dict_leaves(tree[k], f"{path}[{k!r}]")]


def test_cache_axes_structure_matches_caches():
    for arch in ("glm4-9b", "deepseek-v2-236b", "jamba-v0.1-52b",
                 "xlstm-350m", "gemma3-4b"):
        cfg = get_config(arch, smoke=True)
        caches = init_caches(cfg, 2, 64, torch.float32)
        axes = cache_axes(cfg)
        flat_c, flat_a = _dict_leaves(caches), _dict_leaves(axes)
        assert [k for k, _ in flat_c] == [k for k, _ in flat_a], arch
        for (_, c), (_, a) in zip(flat_c, flat_a):
            assert len(a) == c.dim(), (arch, a, c.shape)


def test_placements_split_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")
    assert placements_for((("pod", "data"), None, "model"), names) == (
        Shard(0), Shard(0), Shard(2))
    assert placements_for((None, None), names) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="orders its mesh axes"):
        placements_for((("data", "pod"),), names)


def test_production_mesh_names_the_world_it_needs():
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        make_production_mesh(multi_pod=True, device_type="cpu")


def test_shard_is_a_no_op_without_a_mesh():
    x = torch.ones(2, 3)
    assert shard(x, "batch", None) is x
    with mesh_context(None):
        assert shard(x, "batch", None) is x


# ---------------------------------------------------------------------------
# gradient compression: tests/test_collectives.py's cases, bitwise
# ---------------------------------------------------------------------------

def test_bf16_roundtrip_error_small():
    g = {"w": torch.linspace(-3, 3, 1000)}
    out = coll.decompress_bf16(coll.compress_bf16(g))
    assert float(torch.max(torch.abs(out["w"] - g["w"]))) < 0.02
    ref = ref_coll.decompress_bf16(ref_coll.compress_bf16(
        {"w": jnp.asarray(g["w"].numpy())}))
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(ref["w"]))


def test_int8_ef_accumulates_residual():
    rng = np.random.default_rng(0)
    a = rng.normal(size=256).astype(np.float32)
    g, jg = {"w": torch.from_numpy(a)}, {"w": jnp.asarray(a)}
    ef, jef = coll.ef_init(g), ref_coll.ef_init(jg)
    total_sent = torch.zeros(256)
    n = 50
    for _ in range(n):
        sent, ef = coll.compressed_grad_step(g, ef, mode="int8_ef")
        jsent, jef = ref_coll.compressed_grad_step(jg, jef, mode="int8_ef")
        np.testing.assert_array_equal(sent["w"].numpy(),
                                      np.asarray(jsent["w"]))
        np.testing.assert_array_equal(ef.residual["w"].numpy(),
                                      np.asarray(jef.residual["w"]))
        total_sent = total_sent + sent["w"]
    avg_err = float(torch.max(torch.abs(total_sent / n - g["w"])))
    one_step_err = float(torch.max(torch.abs(coll.compressed_grad_step(
        g, coll.ef_init(g), mode="int8_ef")[0]["w"] - g["w"])))
    assert avg_err < one_step_err * 0.5
    assert avg_err < 5e-3


def test_int8_quantization_bitwise_at_scale():
    """2**22 elements: enough that a quotient one bit off would flip some
    rounding."""
    a = (np.random.default_rng(7).standard_normal(1 << 22) * 5).astype(
        np.float32)
    q, s = coll._quant_int8(torch.from_numpy(a))
    jq, js = ref_coll._quant_int8(jnp.asarray(a))
    assert float(s) == float(js)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@given(st.integers(0, 1000))
@settings(max_examples=20, deadline=None)
def test_int8_ef_residual_bounded(seed):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=64).astype(np.float32) * 10)
    g, jg = {"w": torch.from_numpy(a)}, {"w": jnp.asarray(a)}
    ef, jef = coll.ef_init(g), ref_coll.ef_init(jg)
    for _ in range(10):
        q, s, ef_next = coll.compress_int8_ef(g, ef)
        jq, js, jef = ref_coll.compress_int8_ef(jg, jef)
        assert q["w"].dtype == torch.int8
        np.testing.assert_array_equal(q["w"].numpy(), np.asarray(jq["w"]))
        np.testing.assert_array_equal(s["w"].numpy(), np.asarray(js["w"]))
        np.testing.assert_array_equal(ef_next.residual["w"].numpy(),
                                      np.asarray(jef.residual["w"]))
        _, ef = coll.compressed_grad_step(g, ef, mode="int8_ef")
    scale = float(torch.max(torch.abs(g["w"])))
    assert float(torch.max(torch.abs(ef.residual["w"]))) <= scale / 127 + 1e-5


def test_mode_none_is_identity():
    g = {"w": torch.arange(4.0)}
    out, ef = coll.compressed_grad_step(g, None, mode="none")
    assert out is g and ef is None
    with pytest.raises(ValueError):
        coll.compressed_grad_step(g, None, mode="fp8")


def test_bubble_fraction():
    assert pipeline_bubble_fraction(4, 8) == 3 / 11


# ---------------------------------------------------------------------------
# several gloo ranks
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent('''
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def case_step(rank, world, d, a):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.bridge import lm_params_from_reference
        from repro_torch.checkpoint.io import keypath_items
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import rules_for
        from repro_torch.models import lm_init
        from repro_torch.models.layers import param_axes
        from repro_torch.parallel.sharding import (logical_sharding,
                                                   mesh_context)
        from repro_torch.train import AdamWConfig, adamw_init, make_train_step

        cfg = get_config(a["arch"], smoke=True)
        mesh = init_device_mesh("cpu", tuple(a["shape"]),
                                mesh_dim_names=("data", "model"))
        axes = param_axes(lm_init(cfg, torch.Generator().manual_seed(0)))
        with np.load(os.path.join(d, "params.npz")) as z:
            values = lm_params_from_reference({k: z[k] for k in z.files})
        with np.load(os.path.join(d, "batch.npz")) as z:
            batch = {k: torch.from_numpy(z[k]) for k in z.files}
        opt_cfg = AdamWConfig(lr=1e-3, schedule="constant", warmup_steps=0)
        with mesh_context(mesh, rules_for(cfg, "train", a["overrides"])):
            def place(v, ax):
                if isinstance(v, dict):
                    return {k: place(v[k], ax[k]) for k in v}
                return distribute_tensor(v, mesh, logical_sharding(ax, mesh))
            dv = place(values, axes)
            p, _, m = make_train_step(cfg, opt_cfg)(dv, adamw_init(dv, opt_cfg),
                                                    batch)
        full = {k: v.full_tensor().numpy() for k, v in keypath_items(p)}
        if rank == 0:
            np.savez(os.path.join(d, "out.npz"), **full)
            with open(os.path.join(d, "loss.json"), "w") as f:
                json.dump(float(m["loss"]), f)


    def case_grads(rank, world, d, a):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.checkpoint.io import keypath_items
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import rules_for
        from repro_torch.models import lm_init
        from repro_torch.parallel.sharding import (logical_sharding,
                                                   mesh_context)
        from repro_torch.train import loss_and_grads

        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out = {}
        for arch in a["archs"]:
            cfg = get_config(arch, smoke=True)
            params = lm_init(cfg, torch.Generator().manual_seed(0))
            with np.load(os.path.join(d, f"{arch}.npz")) as z:
                batch = {k: torch.from_numpy(z[k]) for k in z.files}
            with mesh_context(mesh, rules_for(cfg, "train")):
                def place(p):
                    if isinstance(p, dict):
                        return {k: place(v) for k, v in p.items()}
                    return distribute_tensor(p.value, mesh,
                                             logical_sharding(p.axes, mesh))
                loss, _, g = loss_and_grads(cfg, place(params), batch)
            out[f"{arch}/loss"] = loss.numpy()
            for k, v in keypath_items(g):
                out[f"{arch}/{k}"] = v.full_tensor().numpy()
        if rank == 0:
            np.savez(os.path.join(d, "out.npz"), **out)


    def case_pipeline(rank, world, d, a):
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.parallel.pipeline import pipeline_apply

        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
        with np.load(os.path.join(d, "pipe.npz")) as z:
            ws, x = torch.from_numpy(z["ws"]), torch.from_numpy(z["x"])
        out = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x, mesh,
                             axis="pod")
        if rank == 0:
            np.save(os.path.join(d, "out.npy"), out.numpy())


    def case_save(rank, world, d, a):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Shard, distribute_tensor
        from repro_torch.checkpoint import CheckpointConfig, CheckpointManager

        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
        w = distribute_tensor(torch.arange(64.0).reshape(8, 8), mesh,
                              [Shard(0)])
        assert w.to_local().shape == (2, 8)
        mgr = CheckpointManager(CheckpointConfig(directory=a["ckpt"],
                                                 async_save=False))
        mgr.save(5, {"w": w})
        mgr.wait()


    def case_restore(rank, world, d, a):
        from repro_torch.checkpoint import (CheckpointConfig,
                                            CheckpointManager, reshard_to)
        from repro_torch.parallel.sharding import placements_for
        from repro_torch.runtime import build_mesh, plan_mesh

        plan = plan_mesh(world, model_parallel=2)
        mesh = build_mesh(plan)
        try:  # the group is smaller than this plan
            build_mesh(plan_mesh(2 * world, model_parallel=2))
            raise AssertionError("build_mesh took a plan larger than the "
                                 "group")
        except ValueError as e:
            assert f"need {2 * world} devices, have {world}" in str(e)
        mgr = CheckpointManager(CheckpointConfig(directory=a["ckpt"]))
        restored, meta = mgr.restore({"w": np.zeros((8, 8), np.float32)})
        sh = {"w": (mesh, placements_for(("model", None), mesh))}
        w = reshard_to(restored, sh)["w"]
        assert meta["step"] == 5
        assert w.to_local().shape == (4, 8), w.to_local().shape
        full = w.full_tensor()
        np.testing.assert_array_equal(full.numpy(),
                                      np.arange(64.0).reshape(8, 8))
        if rank == 0:
            with open(os.path.join(d, "ok.txt"), "w") as f:
                f.write(f"RESHARDED {tuple(mesh.shape)} {w.placements}")


    def main(rank, world, d, case, a):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            d, "rendezvous"), rank=rank, world_size=world)
        try:
            globals()["case_" + case](rank, world, d, a)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        d, case, world = sys.argv[1], sys.argv[2], int(sys.argv[3])
        with open(os.path.join(d, "args.json")) as f:
            a = json.load(f)
        mp.spawn(main, args=(world, d, case, a), nprocs=world)
''')


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    return env


def spawn(d, case: str, world: int, **args) -> None:
    """Run ``case`` of :data:`WORKER` on ``world`` gloo ranks in a fresh
    subprocess whose files live in ``d``."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "worker.py").write_text(WORKER)
    (d / "args.json").write_text(json.dumps(args))
    out = subprocess.run(
        [sys.executable, str(d / "worker.py"), str(d), case, str(world)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT, env=_env(),
        cwd=ROOT)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("arch,overrides", [
    ("tinyllama-1.1b", None),
    # the smoke config's 4 heads do not divide the production model axis;
    # sharding them over the mesh's 2 takes attention's heads route
    ("tinyllama-1.1b", {"heads": "model", "kv_heads": "model"}),
    ("jamba-v0.1-52b", None),
])
def test_sharded_step_matches_unsharded_and_the_jax_step(arch, overrides,
                                                         tmp_path):
    jcfg = jax_get_config(arch, smoke=True)
    jvals = jax_param_values(jax_lm_init(jax.random.PRNGKey(0), jcfg))
    flat = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jvals)[0]}
    d = tmp_path / "step"
    d.mkdir()
    np.savez(d / "params.npz", **flat)
    cfg = get_config(arch, smoke=True)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=8, seed=0))
    batch = data.batch_at(0)
    np.savez(d / "batch.npz", **batch)

    spawn(d, "step", 4, arch=arch, shape=[2, 2], overrides=overrides)
    with np.load(d / "out.npz") as z:
        sharded = {k: z[k] for k in z.files}
    sharded_loss = json.loads((d / "loss.json").read_text())

    opt_cfg = AdamWConfig(lr=1e-3, schedule="constant", warmup_steps=0)
    values = lm_params_from_reference(flat)
    p1, _, m1 = make_train_step(cfg, opt_cfg)(
        values, adamw_init(values, opt_cfg),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    unsharded = {k: v.numpy() for k, v in keypath_items(p1)}
    assert set(sharded) == set(unsharded) == set(flat)
    assert abs(sharded_loss - float(m1["loss"])) <= 1e-5 * max(
        1.0, abs(float(m1["loss"])))
    for k in unsharded:
        assert _rel_err(sharded[k], unsharded[k]) <= 1e-4, k

    jopt = JaxAdamWConfig(lr=1e-3, schedule="constant", warmup_steps=0)
    jp, _, jm = jax.jit(jax_train_step(jcfg, jopt))(
        jvals, jax_adamw_init(jvals, jopt),
        {k: jnp.asarray(v) for k, v in batch.items()})
    jflat = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert abs(sharded_loss - float(jm["loss"])) < 1e-3
    worst = max(float(np.max(np.abs(sharded[k] - jflat[k]))) for k in jflat)
    assert worst < 5e-3, worst


@pytest.mark.parametrize("archs", [
    ("arctic-480b", "deepseek-v2-236b", "gemma3-4b", "glm4-9b"),
    ("granite-3-8b", "llava-next-34b", "whisper-base", "xlstm-350m"),
])
def test_every_other_config_runs_sharded(archs, tmp_path):
    """The smoke configs not held above, each on a (data 2, model 2)
    mesh under ``rules_for(cfg, "train")``: the loss within 1e-5 and every
    gradient within 1e-4 (relative to its norm) of the unsharded port's.
    (Gradients, not AdamW's update: where a gradient is zero in one run
    and a rounding residue in the other, the update's sign differs.)"""
    from repro_torch.models import param_values
    from repro_torch.train import loss_and_grads

    d = tmp_path / "grads"
    d.mkdir()
    want = {}
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                       global_batch=8, seed=0)).batch_at(0)
        if cfg.is_encdec:
            batch["frames"] = np.random.default_rng(1).standard_normal(
                (8, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
        np.savez(d / f"{arch}.npz", **batch)
        values = param_values(lm_init(cfg, torch.Generator().manual_seed(0)))
        loss, _, g = loss_and_grads(
            cfg, values, {k: torch.from_numpy(v) for k, v in batch.items()})
        want[arch] = (float(loss), dict(keypath_items(g)))
    spawn(d, "grads", 4, archs=list(archs))
    with np.load(d / "out.npz") as z:
        got = {k: z[k] for k in z.files}
    for arch, (loss, grads) in want.items():
        assert abs(float(got[f"{arch}/loss"]) - loss) <= 1e-5 * max(
            1.0, abs(loss)), arch
        for k, g in grads.items():
            assert _rel_err(got[f"{arch}/{k}"], g.numpy()) <= 1e-4, (arch, k)


def test_pipeline_matches_sequential_and_the_jax_pipeline(tmp_path):
    P, M, mb, dim = 4, 8, 2, 16
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((P, dim, dim)) / np.sqrt(dim)).astype(
        np.float32)
    x = rng.standard_normal((M, mb, dim)).astype(np.float32)
    d = tmp_path / "pipe"
    d.mkdir()
    np.savez(d / "pipe.npz", ws=ws, x=x)
    spawn(d, "pipeline", P)
    got = np.load(d / "out.npy")

    want = torch.from_numpy(x)
    for s in range(P):
        want = torch.tanh(want @ torch.from_numpy(ws[s]))
    assert float(np.max(np.abs(got - want.numpy()))) < 1e-5

    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.parallel.pipeline import pipeline_apply
        z = np.load(r'{d / "pipe.npz"}')
        mesh = jax.make_mesh(({P},), ('pod',))
        out = pipeline_apply(lambda w, h: jnp.tanh(h @ w),
                             jnp.asarray(z['ws']), jnp.asarray(z['x']),
                             mesh, axis='pod')
        np.save(r'{d / "jax.npy"}', np.asarray(out))
    """)
    env = _env()
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={P}"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=SPAWN_TIMEOUT, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert float(np.max(np.abs(got - np.load(d / "jax.npy")))) < 1e-5


def test_elastic_restart_reshards_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    spawn(tmp_path / "save", "save", 4, ckpt=ckpt)
    spawn(tmp_path / "restore", "restore", 2, ckpt=ckpt)
    assert (tmp_path / "restore" / "ok.txt").read_text().startswith(
        "RESHARDED (1, 2)")


def test_launch_train_model_parallel_on_four_ranks(tmp_path):
    out_file = tmp_path / "losses.json"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--smoke", "--model-parallel", "2",
         "--steps", "3", "--seq", "32", "--losses-out", str(out_file)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT, env=_env(),
        cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("done: loss ") == 1  # rank 0 alone prints
    sharded = json.loads(out_file.read_text())
    single = launch_train.run(launch_train.parser().parse_args(
        ["--device", "cpu", "--smoke", "--steps", "3", "--seq", "32"]))
    assert [s for s, _ in sharded] == [s for s, _ in single["losses"]]
    for (_, a), (_, b) in zip(sharded, single["losses"]):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (a, b)


def test_launch_train_world_of_one_is_the_unsharded_run_bit_for_bit():
    """Without a process group, --model-parallel gives a (1, 1) mesh of
    DTensors: the same kernels (here their plain versions) in the same
    order as the run without a mesh."""
    base = ["--device", "cpu", "--smoke", "--steps", "2", "--seq", "16",
            "--batch", "4", "--microbatches", "2"]
    plain = launch_train.run(launch_train.parser().parse_args(base))
    meshed = launch_train.run(launch_train.parser().parse_args(
        base + ["--model-parallel", "1"]))
    assert meshed["losses"] == plain["losses"]
    leaves = keypath_items(meshed["state"])
    assert all(hasattr(v, "placements") for k, v in leaves
               if ".step" not in k)
    want = dict(keypath_items(plain["state"]))
    for k, v in leaves:
        got = v.full_tensor() if hasattr(v, "placements") else v
        assert torch.equal(got, want[k]), k
