"""The benchmark's counts of work held to hand-worked values."""

import json
from pathlib import Path

import pytest

from perfbench import counts

ROOT = Path(__file__).resolve().parents[2]


def _config(name):
    with open(ROOT / "perfbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_live_pairs_causal_and_windowed():
    assert counts.live_pairs(4) == 10
    assert counts.live_pairs(2048) == 2048 * 2049 // 2
    # a window of 2 over 4 positions: 1 + 2 + 2 + 2
    assert counts.live_pairs(4, window=2) == 7
    assert counts.live_pairs(3, causal=False) == 9


def test_mla_attention_call_at_192_128():
    # B 8, H = Hkv 128, S 2,048, q/k 192 and v 128 columns, causal
    w = counts.attention_call((8, 128, 2048, 192), 128, 128, True, 0,
                              "bfloat16")
    pairs = 2_098_176                          # 2048 * 2049 / 2
    assert w["flops"] == 2 * 8 * 128 * pairs * 320 == 1_375_060_623_360
    # q 402,653,184 + k and v 671,088,640 + out 268,435,456 elements
    assert w["bytes"] == 2 * 1_342_177_280
    # operations bound it: 1.39 ms against 0.80 ms of bytes
    assert counts.least_seconds(w, "bfloat16") == pytest.approx(
        1_375_060_623_360 / 989.4e12)


def test_swiglu_call_is_6_m_d_f():
    w = counts.swiglu_call(768, 5120, 1536, "bfloat16")
    assert w["flops"] == 6 * 768 * 5120 * 1536 == 36_238_786_560
    assert w["bytes"] == (2 * 768 * 5120 + 3 * 5120 * 1536) * 2 \
        == 62_914_560
    # at M 16 the weights' bytes bound it
    small = counts.swiglu_call(16, 5120, 1536, "bfloat16")
    assert counts.least_seconds(small, "bfloat16") == pytest.approx(
        small["bytes"] / 3.35e12)


def test_rmsnorm_call():
    w = counts.rmsnorm_call(16384, 5120, "bfloat16", "bfloat16")
    assert w["flops"] == 335_544_320
    assert w["bytes"] == 335_544_320 + 10_240


def test_deepseek_forward_flops():
    c = _config("deepseek_v2_4l")
    mla = (5120 * 1536 + 1536 * 128 * 192 + 5120 * 576 + 512 * 128 * 256
           + 128 * 128 * 5120)
    assert mla == 149_225_472
    dense = 3 * 5120 * 12288                   # 188,743,680
    moe = 5120 * 160 + 8 * 3 * 5120 * 1536     # router, 6 routed + 2 shared
    weights = (mla + dense) + 3 * (mla + moe)
    assert weights == 1_354_334_208
    head = 5120 * 102400
    pair = 2 * 128 * (128 + 64 + 128)          # 81,920 a live pair a layer
    # one token alone
    assert counts.forward_flops(c, 1, 1, 0, 1) == \
        2 * weights + 4 * pair + 2 * head == 3_757_572_096
    # a batch of 8 prompts of 2,048, the head on the last row
    assert counts.forward_flops(c, 8, 2048, 0, 1) == (
        2 * 8 * 2048 * weights + 8 * 2_098_176 * 4 * pair
        + 2 * 8 * head)
    # a decode step at position 2,048 attends to 2,049 keys
    assert counts.forward_flops(c, 1, 1, 2048, 1) == \
        2 * weights + 2049 * 4 * pair + 2 * head


def test_jamba_forward_flops():
    c = _config("jamba_8l")
    mamba = 4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096
    assert mamba == 105_119_744
    gqa = 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096
    dense = 3 * 4096 * 14336
    moe = 4096 * 16 + 2 * dense
    weights = 7 * mamba + gqa + 4 * dense + 4 * moe
    assert weights == 2_891_972_608
    scan = 2 * 4 * 8192 + 6 * 8192 * 16        # conv and scan a token
    pair = 2 * 32 * 2 * 128
    head = 4096 * 65536
    assert counts.forward_flops(c, 1, 1, 0, 1) == \
        2 * weights + 7 * scan + pair + 2 * head == 6_326_796_288


def test_batch_flops_sums_prefill_and_steps():
    c = _config("jamba_8l")
    f = counts.batch_flops(c, 8, 1024, 7)
    assert f["prefill"] == counts.forward_flops(c, 8, 1024, 0, 1)
    assert f["decode"] == sum(counts.forward_flops(c, 8, 1, 1024 + t, 1)
                              for t in range(7))
