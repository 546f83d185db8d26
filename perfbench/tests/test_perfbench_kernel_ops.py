"""The kernel-op files (``perfbench/kernels/``): the recorder wraps each
file's attribute of ``repro_torch.kernels.ops`` while it records and puts
it back after; ``mla_decode`` records its positions without reading them,
which holds because the engine never writes them after the call, and
counts its work as ``chip_smoke.py`` bounds the kernel."""

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.serve import Request, ServeConfig, ServeEngine

from perfbench import counts, harness, roofline, spec, weights
from perfbench.tests import smoke_cells

OPS = {"repro_torch::flash_attention": "flash_attention_op",
       "repro_torch::fused_swiglu": "fused_swiglu_op",
       "repro_torch::fused_rmsnorm": "fused_rmsnorm_op",
       "repro_torch::mla_decode": "mla_decode_op"}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_recorder_wraps_every_kernel_op_file_and_puts_it_back():
    files = {f.OP: f.ATTR for f in spec.kernel_ops()}
    assert OPS.items() <= files.items()
    real = {a: getattr(ops, a) for a in files.values()}
    with harness._Recorder():
        assert all(getattr(ops, a) is not f for a, f in real.items())
    assert all(getattr(ops, a) is f for a, f in real.items())


def test_mla_decode_counts_each_rows_live_slots():
    f = spec.kernel_op("repro_torch::mla_decode")
    B, H, T = 4, 128, 2184
    bf16 = torch.bfloat16
    positions = torch.tensor([0, 5, 2183, 2190])
    call = f.record(torch.zeros(B, H, 512, dtype=bf16),
                    torch.zeros(B, H, 64, dtype=bf16),
                    torch.zeros(B, T, 512, dtype=bf16),
                    torch.zeros(B, T, 64, dtype=bf16), positions, 0.07)
    assert call[-1] is positions         # kept, not read
    live = 1 + 6 + 2184 + 2184           # the last row's clamped to T
    w, dt = roofline.work("repro_torch::mla_decode", call)
    assert dt == "bfloat16"
    assert w == counts.mla_decode_call(B, H, 512, 64, live, "bfloat16")
    # 2 H live (2 kvr + r); (live (kvr + r) + B H (2 kvr + r)) bf16 bytes
    assert w["flops"] == 2 * 128 * 4375 * 1088 == 1_218_560_000
    assert w["bytes"] == (4375 * 576 + 4 * 128 * 1088) * 2 == 6_154_112


def test_the_engine_never_writes_mla_decodes_positions(monkeypatch):
    """Every decode step against a bf16 cache at the latent route's widths
    hands the latent attention a positions tensor that nothing writes
    after the call, so reading it once the trace is over reads what the
    call saw."""
    conf = smoke_cells.config("deepseek-v2-236b", kv_lora_rank=512,
                              rope_head_dim=64)
    cfg = ModelConfig(**conf["port"])
    seed = 2**31 + 11
    tree, _ = weights.draw(cfg, seed, "cpu")
    seen = []
    real = ops.mla_decode_plain

    def spy(q_lat, q_rope, ckv, k_rope, positions, scale):
        seen.append((positions, positions.clone()))
        return real(q_lat, q_rope, ckv, k_rope, positions, scale)
    monkeypatch.setattr(ops, "mla_decode_plain", spy)
    eng = ServeEngine(cfg, tree, ServeConfig(max_batch=2, max_len=24,
                                             cache_dtype=torch.bfloat16))
    prompts = torch.randint(0, cfg.vocab, (2, 10),
                            generator=torch.Generator().manual_seed(seed))
    eng.generate([Request(rid=i, prompt=prompts[i].numpy(),
                          max_new_tokens=5) for i in range(2)])
    # 4 decode steps, one call a MLA layer
    assert len(seen) == 4 * cfg.n_layers
    assert all(torch.equal(p, p0) for p, p0 in seen)
    assert sorted({int(p[0]) for p, _ in seen}) == [10, 11, 12, 13]
