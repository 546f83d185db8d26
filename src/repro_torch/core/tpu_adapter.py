"""One transformer block of a model config as a Cocco graph.

The ``tpu:`` workload scheme (:mod:`repro_torch.api.workloads`) lowers a
block of a bundled :mod:`repro_torch.configs` architecture through
:func:`build_block_graph`, so the MoE, Mamba and ViT block graphs are
explorable by every strategy.  The graph's rows are tokens: pointwise ops
(norms, projections, gates) are F=1, s=1 edges, and attention over the
sequence is a FULL edge.  Line bytes are the per-token tensor widths in
bf16 after tensor-parallel sharding, and weights are the per-device shards.

The port's copy of ``repro.core.tpu_adapter.build_block_graph``.  The
planner that maps a device's memory hierarchy onto the cost model over
this graph is :func:`repro_torch.core.h100_adapter.plan_architecture`,
for the H100.
"""

from __future__ import annotations

from repro_torch.models.config import FFN_MOE, FFN_MOE_RESIDUAL, ModelConfig

from .graph import FULL, Graph


def build_block_graph(cfg: ModelConfig, layer_idx: int, tokens: int,
                      tp_degree: int = 16) -> Graph:
    """One transformer block as a Cocco graph.  Rows = tokens; line bytes =
    per-token tensor width (bf16, TP-sharded).  Weights are the per-device
    TP shards."""
    spec = cfg.block_specs()[layer_idx]
    d = cfg.d_model
    bf = 2
    g = Graph(f"{cfg.name}.L{layer_idx}.{spec.code}")

    def line(width):  # per-token bytes after TP sharding of the width dim
        return max(1, int(width * bf))

    x = g.add_node("x", tokens, line(d))
    n1 = g.add_node("norm1", tokens, line(d), weight_bytes=d * bf,
                    macs=4 * d)
    g.add_edge(x, n1)

    h, kh = cfg.n_heads, cfg.n_kv_heads
    dh, dv = cfg.head_dim, cfg.v_dim
    if spec.mixer in ("attn", "attn_local", "attn_mla"):
        qkv_w = (d * (h * dh + 2 * kh * dh)) // tp_degree * bf
        qkv = g.add_node("qkv", tokens, line((h * dh + 2 * kh * dh)
                                             // tp_degree),
                         weight_bytes=qkv_w,
                         macs=tokens and 2 * d * (h * dh + 2 * kh * dh)
                         // tp_degree)
        g.add_edge(n1, qkv)
        attn = g.add_node("attn", tokens, line(h * dv // tp_degree),
                          macs=4 * tokens * (h // tp_degree) * dh // 2)
        g.add_edge(qkv, attn, kind=FULL)   # sequence-global dependency
        proj = g.add_node("attn_proj", tokens, line(d),
                          weight_bytes=h * dv * d // tp_degree * bf,
                          macs=2 * h * dv * d // tp_degree)
        g.add_edge(attn, proj)
        mix_out = g.add_node("add1", tokens, line(d), macs=d)
        g.add_edge(proj, mix_out)
        g.add_edge(x, mix_out)
    else:  # ssm/recurrent mixers: token-local once state is carried
        di = cfg.mamba_expand * d if spec.mixer == "mamba" else 2 * d
        inp = g.add_node("ssm_in", tokens, line(2 * di // tp_degree),
                         weight_bytes=d * 2 * di // tp_degree * bf,
                         macs=2 * d * 2 * di // tp_degree)
        g.add_edge(n1, inp)
        conv = g.add_node("ssm_conv", tokens, line(di // tp_degree),
                          weight_bytes=4 * di // tp_degree * bf,
                          macs=8 * di // tp_degree, )
        g.add_edge(inp, conv, F=4, s=1)
        scan = g.add_node("ssm_scan", tokens, line(di // tp_degree),
                          macs=10 * di * cfg.mamba_d_state // tp_degree)
        g.add_edge(conv, scan, F=1, s=1)
        outp = g.add_node("ssm_out", tokens, line(d),
                          weight_bytes=di * d // tp_degree * bf,
                          macs=2 * di * d // tp_degree)
        g.add_edge(scan, outp)
        mix_out = g.add_node("add1", tokens, line(d), macs=d)
        g.add_edge(outp, mix_out)
        g.add_edge(x, mix_out)

    if spec.ffn == "none":
        g.nodes[mix_out].is_output = True
        return g

    n2 = g.add_node("norm2", tokens, line(d), weight_bytes=d * bf, macs=4 * d)
    g.add_edge(mix_out, n2)
    dff = (cfg.d_ff_expert if spec.ffn in (FFN_MOE, FFN_MOE_RESIDUAL)
           else cfg.d_ff)
    dff_eff = dff * (cfg.top_k if spec.ffn in (FFN_MOE, FFN_MOE_RESIDUAL)
                     else 1)
    up = g.add_node("ffn_up_gate", tokens, line(2 * dff_eff // tp_degree),
                    weight_bytes=2 * d * dff_eff // tp_degree * bf,
                    macs=4 * d * dff_eff // tp_degree)
    g.add_edge(n2, up)
    gate = g.add_node("ffn_act", tokens, line(dff_eff // tp_degree),
                      macs=8 * dff_eff // tp_degree)
    g.add_edge(up, gate)
    down = g.add_node("ffn_down", tokens, line(d),
                      weight_bytes=dff_eff * d // tp_degree * bf,
                      macs=2 * dff_eff * d // tp_degree)
    g.add_edge(gate, down)
    out = g.add_node("add2", tokens, line(d), macs=d, is_output=True)
    g.add_edge(down, out)
    g.add_edge(mix_out, out)
    return g
