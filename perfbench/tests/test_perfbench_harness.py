"""The harness on the CPU at smoke widths: a sound run comes out correct,
and the same run with the timed path broken underneath comes out not
correct, once for each fault a serving cell can have.  Also the files
``BENCHMARK.json`` names, found by name, and the configurations'
published keys against the program's config."""

import json
import math
import re
import time
from pathlib import Path

import pytest
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.serve import engine as engine_mod

from perfbench import harness, spec, traffic, weights
from perfbench.tests import smoke_cells

ROOT = Path(__file__).resolve().parents[2]
ARCHS = ("deepseek-v2-236b", "jamba-v0.1-52b")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(arch, seed=2**31 + 17):
    return harness.execute(smoke_cells.cell(arch), seed, 0.2, 0, "cpu",
                           time.perf_counter())


@pytest.mark.parametrize("arch", ARCHS)
def test_a_sound_run_is_correct(arch):
    r = _run(arch)
    assert r["correct"] and r["failed"] == 0
    # the window holds whole blocks: each prompt length equally often
    block = smoke_cells.SMOKE_MIX["batch"] * len(
        smoke_cells.SMOKE_MIX["prompt_lens"])
    assert r["attempted"] >= block and r["attempted"] % block == 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["mean_gap"]["value"] <= 1e-5
    assert r["gaps"]["tokens"] == 4 * smoke_cells.SMOKE_MIX["new_tokens"]
    for name in ("setup_s", "output_tokens_per_s", "ttft_p95_ms",
                 "serve_mfu", "prefill_ms", "decode_step_ms"):
        assert r["metrics"][name]["value"] > 0


def _token_altered(real):
    """Row 0's next token: the program's second choice, at every step."""
    def apply(values, cfg, tokens, *a, **kw):
        logits, caches, aux = real(values, cfg, tokens, *a, **kw)
        logits = logits.clone()
        second = logits[0, -1].topk(2).indices[1]
        logits[0, -1, second] = logits[0, -1].max() + 1.0
        return logits, caches, aux
    return apply


def _state_unchanged(real):
    """Decode steps that leave the caches as they found them."""
    def apply(values, cfg, tokens, *a, caches=None, prefill=False, **kw):
        if prefill or caches is None:
            return real(values, cfg, tokens, *a, caches=caches,
                        prefill=prefill, **kw)

        def copy(t):
            return {k: copy(v) for k, v in t.items()} \
                if isinstance(t, dict) else t.clone()
        logits, _, aux = real(values, cfg, tokens, *a, caches=copy(caches),
                              **kw)
        return logits, caches, aux
    return apply


def _half_batch(real):
    """The second half of the batch left out: its rows take the first
    half's logits."""
    def apply(values, cfg, tokens, *a, **kw):
        logits, caches, aux = real(values, cfg, tokens, *a, **kw)
        h = logits.shape[0] // 2
        logits = torch.cat([logits[:h], logits[:logits.shape[0] - h]])
        return logits, caches, aux
    return apply


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch])
def test_a_broken_timed_path_is_not_correct(arch, fault, monkeypatch):
    monkeypatch.setattr(engine_mod, "lm_apply", fault(engine_mod.lm_apply))
    r = _run(arch)
    assert not r["correct"]
    assert r["failed"] > 0
    assert r["checks"]["mean_gap"]["value"] > r["checks"]["mean_gap"]["limit"]


def test_a_request_without_its_tokens_fails(monkeypatch):
    real = engine_mod.ServeEngine.generate

    def short(self, requests):
        out = real(self, requests)
        out[requests[-1].rid] = out[requests[-1].rid][:-1]
        return out
    monkeypatch.setattr(engine_mod.ServeEngine, "generate", short)
    r = _run(ARCHS[0])
    assert not r["correct"] and r["checks"]["missing_requests"]["value"] > 0


def test_traffic_gives_every_seed_the_same_sizes():
    mix = spec.load_json(ROOT / "perfbench/traffic/prefill_short.json")
    for seed in (0, 2**31 + 5, 2**32 + 3):
        lens = [traffic.prompt_len(mix, seed, i) for i in range(8)]
        for b in range(4):
            assert sorted(lens[2 * b:2 * b + 2]) == [1024, 2048]
    a = traffic.batch(mix, 1000, 7, 3)
    b = traffic.batch(mix, 1000, 7, 3)
    assert (a.prompts == b.prompts).all() and a.prompts.shape[0] == 8
    assert not (traffic.batch(mix, 1000, 8, 3).prompts[:, :10]
                == a.prompts[:, :10]).all()
    finished = [(i, r, traffic.prompt_len(mix, 7, i)) for i in range(10)
                for r in range(8)]
    picked = traffic.sample(mix, 7, finished)
    assert len(picked) == mix["check_requests"] == len(set(picked))
    assert max(p[2] for p in picked) == 2048


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_names_files_that_are_there():
    bench = spec.load_json(ROOT / "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"])
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
        assert callable(spec.reader(m["name"]))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench)
        names = {n for n, _ in c["metrics"][0]}
        assert "setup_s" in names and len(names) >= 2 and c["metrics"][1]
        for m in bench["per_layer"]:
            if w["name"] in m.get("workloads", [w["name"]]):
                assert m["moves"] in names
        assert c["limits"]["mean_gap"] > 0
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()


def _published_matches_port(c):
    cfg = ModelConfig(**c["port"])
    assert c["num_hidden_layers"] == cfg.n_layers == len(c["layers"])
    assert c["layers"] == weights.layer_kinds(cfg)
    assert c["hidden_size"] == cfg.d_model
    assert c["num_attention_heads"] == cfg.n_heads
    assert c["vocab_size"] == cfg.vocab
    assert c["rms_norm_eps"] == cfg.norm_eps
    assert c["num_experts_per_tok"] == cfg.top_k
    assert c["intermediate_size"] == cfg.d_ff
    assert c["assumed"]["capacity_factor"] == cfg.capacity_factor
    assert c["tie_word_embeddings"] == cfg.tie_embeddings
    assert c["hidden_act"] == cfg.act
    return cfg


def test_deepseek_config_is_the_program_config():
    c = spec.load_json(ROOT / "perfbench/configs/deepseek_v2_4l.json")
    cfg = _published_matches_port(c)
    assert (c["q_lora_rank"], c["kv_lora_rank"], c["qk_nope_head_dim"],
            c["qk_rope_head_dim"], c["v_head_dim"]) == (
        cfg.q_lora_rank, cfg.kv_lora_rank, cfg.head_dim, cfg.rope_head_dim,
        cfg.v_dim)
    assert (c["n_routed_experts"], c["n_shared_experts"],
            c["moe_intermediate_size"], c["first_k_dense_replace"],
            c["rope_theta"]) == (cfg.n_experts, cfg.n_shared_experts,
                                 cfg.d_ff_expert, cfg.first_k_dense,
                                 cfg.rope_theta)
    assert c["topk_method"] == "greedy" and c["norm_topk_prob"] is True
    assert c["rope_scaling"]["factor"] == 1


def test_jamba_config_is_the_program_config():
    c = spec.load_json(ROOT / "perfbench/configs/jamba_8l.json")
    cfg = _published_matches_port(c)
    assert (c["num_key_value_heads"], c["num_experts"], c["mamba_d_state"],
            c["mamba_d_conv"], c["mamba_expand"]) == (
        cfg.n_kv_heads, cfg.n_experts, cfg.mamba_d_state, cfg.mamba_d_conv,
        cfg.mamba_expand)
    assert c["mamba_dt_rank"] == math.ceil(cfg.d_model / 16)
    assert c["intermediate_size"] == cfg.d_ff_expert
    assert (c["attn_layer_period"], c["attn_layer_offset"],
            c["expert_layer_period"], c["expert_layer_offset"]) == (
        cfg.attn_every, cfg.attn_offset, cfg.moe_every, cfg.moe_offset)


def test_weights_repeat_from_the_seed_and_share_storage():
    conf = smoke_cells.config("jamba-v0.1-52b")
    cfg = ModelConfig(**conf["port"])
    t1, w1 = weights.draw(cfg, 2**31 + 9, "cpu")
    t2, _ = weights.draw(cfg, 2**31 + 9, "cpu")
    assert torch.equal(t1["scan"]["p0"]["mixer"]["in_proj"],
                       t2["scan"]["p0"]["mixer"]["in_proj"])
    # the reference's layer views are the program's stacked tensors
    assert w1["layers"][2]["mixer"]["in_proj"].data_ptr() == \
        t1["scan"]["p0"]["mixer"]["in_proj"][1].data_ptr()
    scale = t1["scan"]["p0"]["norm1"]["scale"]
    assert 0.05 < float(scale.std()) < 0.2


def test_the_result_line_is_json_with_checks_last(capsys, monkeypatch):
    monkeypatch.setattr(harness.spec, "cell",
                        lambda name: smoke_cells.cell(ARCHS[1]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "x", "--seed", "1", "--seconds",
                         "0.1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA" in out.err
    json.dumps(smoke_cells.cell(ARCHS[1]))
