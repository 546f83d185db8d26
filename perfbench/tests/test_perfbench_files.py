"""A configuration's mechanisms and kernel ops are files found by name:
files written outside ``perfbench/`` (an MLA with no q LoRA and unrotated
rope columns, a MoE with sigmoid scores and a routed scale, a toy kernel
op) are drawn, run, counted and recorded once the finder is pointed at
them, and nothing under ``perfbench/`` is written or edited."""

import textwrap

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models import lm_apply, lm_init
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Param

from perfbench import counts, harness, reference, roofline, spec, weights
from perfbench.tests import smoke_cells

MLA_NOPE = '''
    """MLA with no q LoRA whose rope columns are not rotated: the queries
    straight from x through wuq [d, h, dn + r]."""
    from perfbench.reference import mla
    from perfbench.reference.linear import linear

    PORT = "attn_mla"
    KEY = "mixer"
    VARIES = "mla"
    params = mla.params
    pair_flops = mla.pair_flops


    def leaves(cfg):
        out = mla.leaves(cfg)
        del out["wdq"], out["q_norm"]
        d, w = cfg.d_model, cfg.head_dim + cfg.rope_head_dim
        out["wuq"] = ((d, cfg.n_heads, w), ("fan_in", d))
        return out


    def residual(p, c, x, fwd):
        B, S, d = x.shape
        h = c["num_attention_heads"]
        w = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
        q = linear(x, p["wuq"].reshape(d, h * w), fwd.quant)
        return mla.attend(p, c, x, q.view(B, S, h, w), lambda t: t,
                          fwd.quant)
'''

MOE_SIGMOID = '''
    """Routed experts scored by a sigmoid, the top k renormalised to sum 1
    and scaled by routed_scaling_factor."""
    import torch

    from perfbench.reference import moe
    from perfbench.reference.linear import linear

    PORT = "moe"
    KEY = "moe"
    VARIES = "moe"
    leaves = moe.leaves
    params = moe.params


    def residual(p, c, x, fwd):
        k = c["num_experts_per_tok"]
        scores = torch.sigmoid(linear(x, p["router"]))
        topv, topi = torch.topk(scores, k, dim=-1)
        topv = topv / topv.sum(-1, keepdim=True) * c["routed_scaling_factor"]
        w = moe.capacity(c, topi, topv, p["router"].shape[1], fwd.prompt_len)
        return moe.experts(p, x, w, fwd.quant)
'''

TOY_OP = '''
    """A toy kernel op: the plain RMSNorm the port runs on the CPU."""
    from perfbench import counts
    from perfbench.roofline import dtype

    ATTR = "rmsnorm_plain"
    OP = "toy::rmsnorm_plain"


    def record(x, scale, eps):
        return (x.shape[0], x.shape[1], dtype(x), dtype(scale))


    def work(call):
        m, d, dt, sdt = call
        return counts.rmsnorm_call(m, d, dt, sdt), dt
'''


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _snapshot():
    """Every file under ``perfbench/`` but compiled caches, with its size
    and time of change."""
    return {p: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in spec.HERE.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{pre}/{k}")
    else:
        yield pre, tree


@pytest.fixture
def outside(tmp_path, monkeypatch):
    mech, kern = tmp_path / "mechanisms", tmp_path / "kernels"
    mech.mkdir()
    kern.mkdir()
    (mech / "mla_nope.py").write_text(textwrap.dedent(MLA_NOPE))
    (mech / "moe_sigmoid.py").write_text(textwrap.dedent(MOE_SIGMOID))
    (kern / "rmsnorm_plain.py").write_text(textwrap.dedent(TOY_OP))
    monkeypatch.setattr(spec, "MECHANISM_DIRS", spec.MECHANISM_DIRS + [mech])
    monkeypatch.setattr(spec, "KERNEL_DIRS", spec.KERNEL_DIRS + [kern])
    return tmp_path


def test_mechanisms_and_kernel_ops_added_as_files_outside(outside):
    before = _snapshot()
    conf = smoke_cells.config("deepseek-v2-236b", q_lora_rank=0)
    conf["routed_scaling_factor"] = 2.446
    conf["layers"] = [["mla_nope", ffn if ffn == "dense" else "moe_sigmoid"]
                      for _, ffn in conf["layers"]]
    cfg = ModelConfig(**conf["port"])
    weights.check_layers(cfg, conf["layers"])
    # the variants do not take the base mechanisms' place
    assert weights.layer_kinds(cfg) == [
        ["mla", ffn] for _, ffn in smoke_cells.config(
            "deepseek-v2-236b")["layers"]]

    tree, w = weights.draw(cfg, 2**31 + 5, "cpu", conf["layers"])
    # the variants' weights fit the port's parameter tree, leaf for leaf
    port = lm_init(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _flat(tree)} == {
        k: tuple(v.value.shape) for k, v in _flat(
            port, "") if isinstance(v, Param)}
    assert "wdq" not in w["layers"][0]["mixer"]
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits = lm_apply(tree, cfg, toks)[0]
        ref = reference.forward(conf, w, toks, 16, [15])
    assert logits.shape[-1] == ref.shape[-1] == cfg.vocab
    assert torch.isfinite(ref).all()

    flops = counts.batch_flops(conf, 2, 12, 3)
    base = dict(conf, layers=[["mla", ffn if ffn == "dense" else "moe"]
                              for _, ffn in conf["layers"]])
    assert flops == counts.batch_flops(base, 2, 12, 3)
    assert flops["prefill"] > 0 and flops["decode"] > 0

    real = ops.rmsnorm_plain
    with harness._Recorder() as rec:
        ops.rmsnorm(torch.ones(6, 32), torch.ones(32))
    assert ops.rmsnorm_plain is real
    assert rec.calls["toy::rmsnorm_plain"] == [(6, 32, "float32", "float32")]
    assert roofline.work("toy::rmsnorm_plain", (6, 32, "float32",
                                                "float32")) == (
        counts.rmsnorm_call(6, 32, "float32", "float32"), "float32")
    assert _snapshot() == before


@pytest.mark.parametrize("find, path", [
    (lambda: spec.mechanism("no_such_mixer"), "reference/no_such_mixer.py"),
    (lambda: spec.kernel_op("repro_torch::no_such_op"),
     "kernels/no_such_op.py"),
])
def test_an_unknown_name_raises_naming_the_file(find, path):
    with pytest.raises(LookupError, match=str(spec.HERE / path)):
        find()


def test_a_mechanism_of_another_kind_than_the_programs_raises(outside):
    conf = smoke_cells.config("jamba-v0.1-52b")
    cfg = ModelConfig(**conf["port"])
    layers = [list(names) for names in conf["layers"]]
    layers[0][0] = "mla_nope"
    with pytest.raises(ValueError, match="attn_mla"):
        weights.check_layers(cfg, layers)
