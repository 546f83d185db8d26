"""The plain fp32 reference held against the port's plain path (its CPU
route) at smoke widths, on the same tensors: each mechanism alone, and a
prefill then decode through the caches against the reference's full
forward."""

import pytest
import torch

from repro_torch.models import init_caches, lm_apply
from repro_torch.models import layers as port
from repro_torch.models.config import ModelConfig

from perfbench import reference, weights
from perfbench.reference import dense, gqa, mamba, mla, moe
from perfbench.tests import smoke_cells

TOL = 1e-4   # both fp32: summation order only


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed=5, **port):
    conf = smoke_cells.config(arch, **port)
    cfg = ModelConfig(**conf["port"])
    tree, w = weights.draw(cfg, seed, "cpu")
    return conf, cfg, tree, w


def _x(cfg, B=2, S=24, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, S, cfg.d_model), generator=g)


def _close(a, b):
    assert a.shape == b.shape
    assert (a - b).abs().max().item() <= TOL * max(1.0, b.abs().max().item())


def test_mla_matches_the_port():
    conf, cfg, _, w = _setup("deepseek-v2-236b")
    x = _x(cfg)
    pos = torch.arange(x.shape[1])
    p = w["layers"][0]["mixer"]
    ours = port.mla_apply(p, cfg, x, pos[None].expand(2, -1), fresh=True)[0]
    _close(mla.apply(p, conf, x, pos), ours)


def test_gqa_matches_the_port():
    conf, cfg, _, w = _setup("jamba-v0.1-52b")
    li = [m for m, _ in conf["layers"]].index("gqa")
    x = _x(cfg)
    pos = torch.arange(x.shape[1])
    p = w["layers"][li]["mixer"]
    ours = port.attention_apply(p, cfg, x, pos[None].expand(2, -1),
                                fresh=True)[0]
    _close(gqa.apply(p, conf, x, pos), ours)


def test_mamba_matches_the_port():
    conf, cfg, _, w = _setup("jamba-v0.1-52b")
    x = _x(cfg, S=300)     # past one of the reference's chunks
    p = w["layers"][0]["mixer"]
    _close(mamba.apply(p, conf, x), port.mamba_apply(p, cfg, x)[0])


def test_dense_and_moe_match_the_port():
    # half the slots the routing asks for, so that choices are dropped
    conf, cfg, _, w = _setup("deepseek-v2-236b", capacity_factor=0.5)
    x = _x(cfg, S=40)
    _close(dense.apply(w["layers"][0]["ffn"], x),
           port.ffn_apply(w["layers"][0]["ffn"], x))
    p = w["layers"][1]["moe"]
    # the whole sequence one forward: the port drops the choices past an
    # expert's slots, and the reference drops the same
    kept = moe.route(conf, p["router"], x, x.shape[1])
    assert (kept > 0).sum() < x.shape[0] * x.shape[1] * cfg.top_k
    _close(moe.apply(p, conf, x, x.shape[1]), port.moe_apply(p, cfg, x)[0])


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-v0.1-52b"])
def test_prefill_then_decode_matches_the_full_forward(arch):
    conf, cfg, tree, w = _setup(arch, seed=9)
    B, P, n = 2, 20, 6
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (B, P + n), generator=g)
    caches = init_caches(cfg, B, P + n + 8, torch.float32, "cpu")
    with torch.no_grad():
        lg, caches, _ = lm_apply(tree, cfg, toks[:, :P], caches=caches,
                                 prefill=True, last_only=True)
        rows = [lg[:, -1]]
        for t in range(n - 1):
            pos = torch.full((B, 1), P + t)
            lg, caches, _ = lm_apply(tree, cfg, toks[:, P + t:P + t + 1],
                                     positions=pos, caches=caches)
            rows.append(lg[:, -1])
        ref = reference.forward(conf, w, toks[:, :P + n - 1], P,
                                list(range(P - 1, P + n - 1)))
    _close(ref, torch.stack(rows, 1))


def test_the_fp8_control_differs_from_the_reference():
    conf, cfg, _, w = _setup("deepseek-v2-236b")
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        full = reference.forward(conf, w, toks, 16, [15])
        low = reference.forward(conf, w, toks, 16, [15], quant="fp8")
    err = (full - low).abs().max().item()
    assert 1e-3 < err < 0.5 * full.abs().max().item()
