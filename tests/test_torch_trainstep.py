"""The port's training step against the JAX package's, on the CPU: the
loss (``lm_loss``), one whole step's loss and gradients, microbatching,
and ``launch.train`` with its fault-injected restart.

The smoke configs in fp32, the reference's parameters bridged through
NumPy, seeded NumPy batches.  Tolerances: 1e-6 for the loss and its
metrics (one forward, summed in other orders; ``ppl_proxy = exp(loss)``
on its log scale); 1e-5 for a whole step's loss and gradients (each
gradient relative to its norm: they pass through every layer and back).
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm_init as jax_lm_init  # noqa: E402
from repro.models import lm_loss as jax_lm_loss  # noqa: E402
from repro.models import param_values as jax_param_values  # noqa: E402
from repro_torch.bridge import lm_params_from_reference  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm_loss  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402
from repro_torch.train import (AdamWConfig, adamw_init,  # noqa: E402
                               loss_and_grads, make_eval_step,
                               make_train_step)

def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs files on parallel workers: this file's small torch
    work takes two intra-op threads, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def flat(tree):
    """``{keystr path: NumPy array}`` of a JAX tree, or of a port tree of
    nested dicts by the same paths."""
    if isinstance(tree, dict) and tree and all(
            isinstance(v, torch.Tensor) or isinstance(v, dict)
            for v in tree.values()):
        out = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{path}[{k!r}]")
            else:
                out[path] = node.detach().numpy()
        walk(tree, "")
        return out
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def reference(arch):
    jcfg = jax_get_config(arch, smoke=True)
    jvals = jax_param_values(jax_lm_init(jax.random.PRNGKey(0), jcfg))
    return (get_config(arch, smoke=True), jcfg, jvals,
            lm_params_from_reference(np_tree(jvals)))


def make_batch(cfg, B=2, S=12, seed=3, frames=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if frames:
        b["frames"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return b


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def _record_routing(monkeypatch, module, gates_of, calls):
    """Wrap ``module.moe_apply`` to record, at every MoE call, each token's
    k experts (sorted) and its gate margin (the k-th gate less the
    (k+1)-th), from the call's own router input."""
    inner = module.moe_apply

    def recording(params, cfg_, x, act="silu"):
        gates = np.asarray(gates_of(x, params["router"]))
        order = np.argsort(-gates, axis=-1, kind="stable")
        k = cfg_.top_k
        kth, next_ = (np.take_along_axis(gates, order[..., i:i + 1], -1)
                      for i in (k - 1, k))
        calls.append((np.sort(order[..., :k], axis=-1),
                      (kth - next_)[..., 0]))
        return inner(params, cfg_, x, act)

    monkeypatch.setattr(module, "moe_apply", recording)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "arctic-480b",
                                  "whisper-base"])
def test_lm_loss_and_metrics_match(arch, monkeypatch):
    """For arctic the experts each token chooses are compared first, at
    every MoE call, in both packages: the loss follows the routing."""
    cfg, jcfg, jvals, tvals = reference(arch)
    b = make_batch(cfg, frames=cfg.is_encdec)
    port_calls, ref_calls = [], []
    if cfg.n_experts:
        from repro.models import blocks as jax_blocks

        from repro_torch.models import blocks

        _record_routing(monkeypatch, blocks, lambda x, r: torch.softmax(
            x.float() @ r.float(), -1).detach().numpy(), port_calls)
        _record_routing(monkeypatch, jax_blocks, lambda x, r: jax.nn.softmax(
            x.astype(jnp.float32) @ r, -1), ref_calls)
    # the reference's scans run eagerly (recordable); its forward's values
    # do not depend on remat, which would trace the period regardless
    with jax.disable_jit():
        jtotal, jm = jax_lm_loss(jvals, jcfg.with_(remat="none"),
                                 jax_batch(b))
    with torch.no_grad():
        ttotal, tm = lm_loss(tvals, cfg, torch_batch(b))
    assert len(port_calls) == len(ref_calls)
    assert len(ref_calls) == (sum(s.ffn != "dense" for s in
                                  cfg.block_specs()) if cfg.n_experts else 0)
    for (pe, pm), (je, jm_) in zip(port_calls, ref_calls):
        assert np.array_equal(pe, je), (pm.min(), jm_.min())
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-6,
                               atol=1e-6)
    assert set(tm) == set(jm) == {"loss", "aux", "ppl_proxy"}
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   atol=1e-6)
    # ppl_proxy = exp(loss): held on its log scale, where it is the loss
    np.testing.assert_allclose(np.log(float(tm["ppl_proxy"])),
                               np.log(float(jm["ppl_proxy"])), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _rel_close(got, want, tol):
    for key, w in want.items():
        g = got[key]
        scale = max(float(np.linalg.norm(w)), 1e-12)
        err = float(np.linalg.norm(g - w)) / scale
        assert err <= tol, (key, err)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-base"])
def test_train_step_loss_and_gradients_match(arch):
    cfg, jcfg, jvals, tvals = reference(arch)
    b = make_batch(cfg, B=2, S=16, frames=cfg.is_encdec)

    def jloss(v):
        return jax_lm_loss(v, jcfg, jax_batch(b))

    (jtotal, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(jvals)
    ttotal, _, tgrads = loss_and_grads(cfg, tvals, torch_batch(b))
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-5,
                               atol=1e-5)
    want, got = flat(jgrads), flat(tgrads)
    assert set(want) == set(got)
    _rel_close(got, want, 1e-5)
    # every leaf, the stacked layers' included, gets its gradient through
    # the kernels' Functions under remat (the smoke configs keep "full")
    assert cfg.remat == "full"
    assert all(np.isfinite(g).all() and np.abs(g).max() > 0
               for g in got.values())


def test_microbatches_average_gradients_and_keep_the_last_metrics():
    cfg, _, _, tvals = reference("tinyllama-1.1b")
    b = torch_batch(make_batch(cfg, B=4, S=16))
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in b.items()}
              for i in range(2)]
    parts = [loss_and_grads(cfg, tvals, h) for h in halves]
    opt_cfg = AdamWConfig(lr=1e-3, schedule="constant", warmup_steps=0)
    captured = {}
    import repro_torch.train.trainstep as ts

    inner = ts.adamw_update

    def capture(grads, *a):
        captured["grads"] = grads
        return inner(grads, *a)

    ts.adamw_update = capture
    try:
        params = tree_map(lambda t: t.clone(), tvals)
        _, _, m = make_train_step(cfg, opt_cfg, microbatches=2)(
            params, adamw_init(params, opt_cfg), b)
    finally:
        ts.adamw_update = inner
    mean = {k: (flat(parts[0][2])[k] + flat(parts[1][2])[k]) / 2
            for k in flat(parts[0][2])}
    for k, g in flat(captured["grads"]).items():
        np.testing.assert_allclose(g, mean[k], rtol=1e-6, atol=1e-7)
    assert float(m["loss_total"]) == float(parts[1][0])
    assert float(m["loss"]) == float(parts[1][1]["loss"])


def test_microbatch_step_matches_full_batch_when_masks_are_full():
    cfg, _, _, tvals = reference("tinyllama-1.1b")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=8, seed=1))
    b = torch_batch(data.batch_at(0))
    opt_cfg = AdamWConfig(lr=1e-3, schedule="constant", warmup_steps=0)
    out = []
    for mb in (1, 4):
        p = tree_map(lambda t: t.clone(), tvals)
        p, _, _ = make_train_step(cfg, opt_cfg, microbatches=mb)(
            p, adamw_init(p, opt_cfg), b)
        out.append(flat(p))
    # the reference's test_microbatch_accumulation_matches_full_batch
    assert max(float(np.abs(out[0][k] - out[1][k]).max())
               for k in out[0]) < 5e-3


def test_eval_step_gives_the_loss_metrics_without_a_graph():
    cfg, _, _, tvals = reference("tinyllama-1.1b")
    b = torch_batch(make_batch(cfg))
    live = tree_map(lambda t: t.clone().requires_grad_(True), tvals)
    got = make_eval_step(cfg)(live, b)
    _, want = lm_loss(tvals, cfg, b)
    assert set(got) == {"loss", "aux", "ppl_proxy"}
    assert all(v.grad_fn is None for v in got.values())
    assert all(torch.equal(got[k], want[k]) for k in got)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _args(*extra):
    return launch_train.parser().parse_args(
        ["--device", "cpu", "--smoke", "--steps", "4", "--seq", "16",
         "--batch", "4", "--log-every", "1", *extra])


def test_launch_train_restarts_and_replays_the_run(tmp_path, capsys):
    plain = launch_train.run(_args())
    failed = launch_train.run(_args("--ckpt-dir", str(tmp_path / "ck"),
                                    "--save-every", "2", "--fail-at", "3"))
    out = capsys.readouterr().out
    assert "[fault-injection] restarted from 2" in out
    # steps 0, 1, 2 then the failure at 3: restored from step 2, replayed
    assert [s for s, _ in failed["losses"]] == [0, 1, 2, 2, 3]
    assert dict(failed["losses"]) == dict(plain["losses"])
    assert failed["last_loss"] == plain["last_loss"]
    assert np.isfinite(plain["first_loss"])
    from repro_torch.checkpoint import checkpoint_steps

    assert checkpoint_steps(str(tmp_path / "ck")) == [2, 4]
    resumed = launch_train.run(_args("--ckpt-dir", str(tmp_path / "ck"),
                                     "--steps", "5"))
    assert "resumed from step 4" in capsys.readouterr().out
    assert resumed["steps"] == 1


def test_launch_train_cli(tmp_path, capsys):
    rc = launch_train.main(["--device", "cpu", "--smoke", "--steps", "3",
                            "--seq", "16", "--batch", "2"])
    assert rc == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("done: loss ")
    # a (1, 1) mesh in a world of one: the DTensor route, same losses
    assert launch_train.main(["--device", "cpu", "--smoke", "--steps", "3",
                              "--seq", "16", "--batch", "2",
                              "--model-parallel", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("done: loss ")
    assert launch_train.main(["--device", "cpu", "--smoke",
                              "--model-parallel", "0"]) == 2
    assert "model-parallel" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert launch_train.main(["--smoke"]) == 2
        assert capsys.readouterr().err.startswith("error:")
