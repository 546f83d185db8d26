"""The port's checkpoints and fault-tolerance runtime: the nine cases of
``tests/test_checkpoint_runtime.py`` run on ``repro_torch.checkpoint`` and
``repro_torch.runtime`` (on torch tensors where the reference holds jax
arrays), and checkpoints crossing between the two packages: one written by
``repro.checkpoint.save_checkpoint`` (parameters and ``AdamWState``)
restores in the port to equal logits and state, and one written by the
port restores in the JAX package.
"""

import os
import shutil

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm_apply as jax_lm_apply  # noqa: E402
from repro.models import lm_init as jax_lm_init  # noqa: E402
from repro.models import param_values as jax_param_values  # noqa: E402
from repro.train import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import adamw_update as jax_adamw_update  # noqa: E402
from repro_torch.checkpoint import (CheckpointConfig,  # noqa: E402
                                    CheckpointManager, checkpoint_steps,
                                    keypath_items, load_checkpoint,
                                    reshard_to, save_checkpoint,
                                    tree_to_torch)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm_apply, lm_init, param_values  # noqa: E402
from repro_torch.runtime import (Decision, FaultConfig,  # noqa: E402
                                 HeartbeatMonitor, NodeState, RestartPolicy,
                                 build_mesh, mitigate_stragglers, plan_mesh,
                                 rescale_batch, shrink_after_failure)
from repro_torch.train import AdamWConfig, adamw_init  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs files on parallel workers: this file's small torch
    work takes two intra-op threads, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tree():
    return {"a": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
            "b": torch.ones(5, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 10, tree())
    restored, meta = load_checkpoint(d, template=tree())
    np.testing.assert_array_equal(restored["a"]["w"], tree()["a"]["w"])
    assert meta["step"] == 10
    back = tree_to_torch(restored)
    assert torch.equal(back["b"], tree()["b"])


def test_uncommitted_checkpoints_ignored(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, tree())
    broken = os.path.join(d, "step_00000002")
    shutil.copytree(os.path.join(d, "step_00000001"), broken)
    os.remove(os.path.join(broken, "_COMMITTED"))
    assert checkpoint_steps(d) == [1]
    _, meta = load_checkpoint(d)
    assert meta["step"] == 1


def test_corruption_detected(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 5, tree())
    path = os.path.join(d, "step_00000005", "arrays_0.npz")
    with open(path, "r+b") as f:
        f.seek(30)
        f.write(b"\x00\x01\x02\x03")
    with pytest.raises(IOError):
        load_checkpoint(d, verify=True, template=tree())


def test_manager_retention_and_resume(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path), save_every=2, keep_last=2, async_save=False))
    for step in range(1, 9):
        if mgr.should_save(step):
            mgr.save(step, {"x": torch.full((3,), float(step))})
    assert checkpoint_steps(str(tmp_path)) == [6, 8]
    restored, meta = mgr.restore({"x": torch.zeros(3)})
    assert meta["step"] == 8
    np.testing.assert_array_equal(restored["x"], [8, 8, 8])


def test_async_save_waits(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path),
                                             async_save=True))
    t = tree()
    mgr.save(4, t)
    t["a"]["w"].add_(100)  # the save holds a snapshot taken at the call
    mgr.wait()
    assert checkpoint_steps(str(tmp_path)) == [4]
    restored, _ = mgr.restore(tree())
    np.testing.assert_array_equal(restored["a"]["w"], tree()["a"]["w"])
    # no mesh: every leaf a plain tensor on the host
    plain = reshard_to(restored, {"a": {"w": None}, "b": None})
    np.testing.assert_array_equal(plain["a"]["w"].numpy(), tree()["a"]["w"])


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_heartbeat_detects_dead_and_straggler():
    clock = FakeClock()
    cfg = FaultConfig(heartbeat_interval_s=1.0, dead_after_missed=3,
                      straggler_factor=2.0)
    mon = HeartbeatMonitor(cfg, ["n0", "n1", "n2"], clock=clock)
    for t in range(10):
        clock.t = float(t)
        mon.heartbeat("n0", step_time_s=1.0)
        mon.heartbeat("n1", step_time_s=5.0)  # slow
        if t <= 2:
            mon.heartbeat("n2", step_time_s=1.0)
    states = mon.survey()
    assert states["n0"] == NodeState.HEALTHY
    assert states["n1"] == NodeState.SLOW
    assert states["n2"] == NodeState.DEAD


def test_restart_policy_budget():
    clock = FakeClock()
    cfg = FaultConfig(max_restarts_per_hour=2)
    mon = HeartbeatMonitor(cfg, ["n0"], clock=clock)
    pol = RestartPolicy(cfg, clock=clock)
    assert pol.decide(mon, step_failed=False) == Decision.CONTINUE
    assert pol.decide(mon, step_failed=True) == Decision.RESTART_SAME
    assert pol.decide(mon, step_failed=True) == Decision.RESTART_SAME
    assert pol.decide(mon, step_failed=True) == Decision.HALT
    clock.t += 3601
    mon.heartbeat("n0")
    assert pol.decide(mon, step_failed=True) == Decision.RESTART_SAME


def test_straggler_mitigation_rebalances():
    clock = FakeClock()
    cfg = FaultConfig(straggler_factor=2.0)
    mon = HeartbeatMonitor(cfg, ["a", "b"], clock=clock)
    for _ in range(5):
        mon.heartbeat("a", 1.0)
        mon.heartbeat("b", 10.0)
    assert mitigate_stragglers(mon, {"a": 4, "b": 4}) == {"a": 5, "b": 3}


def test_elastic_mesh_planning():
    plan = plan_mesh(512, model_parallel=16, multi_pod=True, pod_size=256)
    assert plan.shape == (2, 16, 16)
    assert plan.axis_names == ("pod", "data", "model")
    single = plan_mesh(256, model_parallel=16)
    assert single.shape == (16, 16)
    shrunk = shrink_after_failure(single, lost_devices=17)
    assert shrunk.shape == (14, 16)
    assert rescale_batch(256, old_data=16, new_data=14) == 224
    shrunk2 = shrink_after_failure(plan, lost_devices=256)
    assert shrunk2.shape == (16, 16)
    with pytest.raises(ValueError, match="process group"):
        build_mesh(single)  # no process group in this process


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

ARCH = "tinyllama-1.1b"


def _jax_state():
    """The reference's smoke parameters and an ``AdamWState`` one update
    in (so that its moments are not zero)."""
    jcfg = jax_get_config(ARCH, smoke=True)
    vals = jax_param_values(jax_lm_init(jax.random.PRNGKey(0), jcfg))
    ocfg = JaxAdamWConfig(warmup_steps=1)
    opt = jax_adamw_init(vals, ocfg)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), vals)
    vals, opt, _ = jax_adamw_update(grads, opt, vals, ocfg)
    return jcfg, vals, opt


def _port_template(opt_dtype="float32"):
    cfg = get_config(ARCH, smoke=True)
    vals = param_values(lm_init(cfg, torch.Generator().manual_seed(1)))
    return cfg, {"params": vals, "opt": adamw_init(
        vals, AdamWConfig(state_dtype=opt_dtype))}


TOKENS = np.random.default_rng(5).integers(0, 256, (2, 10)).astype(np.int32)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jcfg, jvals, jopt = _jax_state()
    jax_ckpt.save_checkpoint(str(tmp_path), 7, {"params": jvals,
                                                "opt": jopt})
    cfg, template = _port_template()
    restored, meta = load_checkpoint(str(tmp_path), template=template)
    assert meta["step"] == 7
    state = tree_to_torch(restored)
    assert int(state["opt"].step) == int(jopt.step) == 1
    for (name, got), (jname, want) in zip(
            keypath_items(state),
            ((jax.tree_util.keystr(p), leaf) for p, leaf in
             jax.tree_util.tree_flatten_with_path(
                 {"params": jvals, "opt": jopt})[0])):
        assert name == jname
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with torch.no_grad():
        logits = lm_apply(state["params"], cfg,
                          torch.from_numpy(TOKENS).long())[0]
    want = jax_lm_apply(jvals, jcfg, jnp.asarray(TOKENS))[0]
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jcfg, jvals, jopt = _jax_state()
    cfg, template = _port_template()
    restored, _ = load_checkpoint(str(_saved(tmp_path, jvals, jopt)),
                                  template=template)
    state = tree_to_torch(restored)
    save_checkpoint(str(tmp_path / "port"), 3, state)
    back, meta = jax_ckpt.load_checkpoint(
        str(tmp_path / "port"), template={"params": jvals, "opt": jopt})
    assert meta["step"] == 3
    assert isinstance(back["opt"], type(jopt))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), back, {"params": jvals, "opt": jopt})
    logits = jax_lm_apply(jax.tree.map(jnp.asarray, back["params"]), jcfg,
                          jnp.asarray(TOKENS))[0]
    with torch.no_grad():
        want = lm_apply(state["params"], cfg,
                        torch.from_numpy(TOKENS).long())[0]
    np.testing.assert_allclose(np.asarray(logits), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def _saved(tmp_path, jvals, jopt):
    d = tmp_path / "jax"
    jax_ckpt.save_checkpoint(str(d), 1, {"params": jvals, "opt": jopt})
    return d


def test_bf16_leaves_cross_as_the_reference_writes_them(tmp_path):
    """A bf16 state (``opt_dtype="bfloat16"``) is written as the
    reference writes bf16 (two raw bytes a value, meta dtype "bfloat16")
    and read back as bf16."""
    jx = {"m": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)}
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 1, jx)
    port = {"m": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)}
    save_checkpoint(str(tmp_path / "port"), 1, port)
    for d in ("jax", "port"):
        arrays, meta = load_checkpoint(str(tmp_path / d))
        assert meta["leaves"]["['m']"] == {"shape": [3], "dtype": "bfloat16"}
        back = tree_to_torch({"m": arrays["['m']"]})
        assert torch.equal(back["m"], port["m"])
