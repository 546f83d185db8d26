"""Model configuration schema covering all 10 assigned architectures.

Layer structure is encoded per-layer as a :class:`BlockSpec` (mixer kind +
ffn kind); the model driver finds the smallest repeating period of the
block-spec sequence and scans over it (HLO stays O(period), essential for the
dry-run of 60-layer 236B-parameter configs).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

# mixer kinds
ATTN = "attn"            # global attention (GQA)
ATTN_LOCAL = "attn_local"  # sliding-window attention
ATTN_MLA = "attn_mla"    # multi-head latent attention (DeepSeek-V2)
MAMBA = "mamba"          # selective SSM
MLSTM = "mlstm"          # xLSTM matrix-memory block
SLSTM = "slstm"          # xLSTM scalar-memory block

# ffn kinds
FFN_DENSE = "dense"      # SwiGLU (or GELU) MLP
FFN_MOE = "moe"          # routed experts (+ optional shared experts)
FFN_MOE_RESIDUAL = "moe_residual"  # dense MLP in parallel with MoE (Arctic)
FFN_NONE = "none"        # block has no separate FFN (xLSTM)


@dataclass(frozen=True)
class BlockSpec:
    mixer: str
    ffn: str

    @property
    def code(self) -> str:
        return f"{self.mixer}/{self.ffn}"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads

    # attention
    rope_theta: float = 10_000.0
    sliding_window: int = 4096
    local_global_period: int = 0  # k: (k-1) local + 1 global per period
    qk_norm: bool = False
    logit_softcap: float = 0.0

    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0          # 0 -> d_head

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0
    moe_every: int = 1           # MoE on layers where idx % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # hybrid / ssm
    attn_every: int = 0          # jamba: attention on idx % attn_every == attn_offset
    attn_offset: int = 0
    slstm_every: int = 0         # xlstm: sLSTM on idx % slstm_every == slstm_offset
    slstm_offset: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # enc-dec (whisper)
    is_encdec: bool = False
    n_enc_layers: int = 0

    # modality frontend stub
    frontend: str = "none"       # none | audio_frames | vision_patches
    n_frontend_tokens: int = 0

    # attention execution (consumption-centric chunking; 0 = always dense)
    attn_chunk: int = 1024

    # numerics / training
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    act: str = "silu"            # silu | gelu
    param_dtype: str = "float32"
    opt_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "none"          # none | full | offload-style policies

    # ----------------------------------------------------------------- #
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def v_dim(self) -> int:
        return self.v_head_dim or self.head_dim

    def mixer_kind(self, idx: int) -> str:
        if self.attn_every:  # hybrid (jamba): mostly mamba, periodic attention
            if idx % self.attn_every == self.attn_offset:
                return ATTN
            return MAMBA
        if self.family == "ssm":
            if self.slstm_every and idx % self.slstm_every == self.slstm_offset:
                return SLSTM
            return MLSTM
        if self.kv_lora_rank:
            return ATTN_MLA
        if self.local_global_period:
            k = self.local_global_period
            return ATTN if idx % k == k - 1 else ATTN_LOCAL
        return ATTN

    def ffn_kind(self, idx: int) -> str:
        if self.d_ff == 0 and not self.n_experts:
            return FFN_NONE
        if not self.n_experts:
            return FFN_DENSE
        if idx < self.first_k_dense:
            return FFN_DENSE
        if idx % self.moe_every == self.moe_offset:
            return (FFN_MOE_RESIDUAL
                    if self.family == "moe" and self.d_ff and self._arctic
                    else FFN_MOE)
        return FFN_DENSE

    @property
    def _arctic(self) -> bool:
        return "arctic" in self.name

    def block_specs(self) -> List[BlockSpec]:
        return [BlockSpec(self.mixer_kind(i), self.ffn_kind(i))
                for i in range(self.n_layers)]

    def period(self) -> int:
        """Smallest repeating period of the block-spec sequence."""
        return self.layout()[1]

    def layout(self) -> Tuple[int, int, int, int]:
        """(prefix, period, reps, remainder): ``prefix`` unrolled layers (e.g.
        DeepSeek's first dense layer), then ``reps`` scans over a
        ``period``-layer body, then ``remainder`` unrolled layers.  Chosen to
        minimize unrolled HLO (prefix + period + remainder)."""
        specs = [s.code for s in self.block_specs()]
        n = len(specs)

        def smallest_period(seq) -> int:
            m = len(seq)
            for p in range(1, m + 1):
                if all(seq[i] == seq[i % p] for i in range(m)):
                    return p
            return m

        best = None
        for f in range(min(n, 8)):  # prefixes beyond a few layers never help
            tail = specs[f:]
            if not tail:
                break
            p = smallest_period(tail)
            reps = len(tail) // p
            rem = len(tail) % p
            score = f + p + rem
            if best is None or score < best[0]:
                best = (score, f, p, reps, rem)
        _, f, p, reps, rem = best
        return f, p, reps, rem

    # -- parameter counting (for roofline MODEL_FLOPS) --------------------
    def param_count(self) -> int:
        return sum(self._layer_params(i) for i in range(self.n_layers)) + \
            self._embed_params()

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared only)."""
        total = self._embed_params()
        for i in range(self.n_layers):
            total += self._layer_params(i, active_only=True)
        return total

    def _embed_params(self) -> int:
        n = self.vocab * self.d_model
        if not self.tie_embeddings:
            n *= 2
        if self.is_encdec:
            n += self.n_frontend_tokens and 0
        return n

    def _mixer_params(self, kind: str) -> int:
        d = self.d_model
        if kind in (ATTN, ATTN_LOCAL):
            q = d * self.n_heads * self.head_dim
            kv = 2 * d * self.n_kv_heads * self.head_dim
            o = self.n_heads * self.v_dim * d
            return q + kv + o
        if kind == ATTN_MLA:
            qa = d * self.q_lora_rank if self.q_lora_rank else 0
            qb = (self.q_lora_rank or d) * self.n_heads * (
                self.head_dim + self.rope_head_dim)
            kva = d * (self.kv_lora_rank + self.rope_head_dim)
            kvb = self.kv_lora_rank * self.n_heads * (self.head_dim + self.v_dim)
            o = self.n_heads * self.v_dim * d
            return qa + qb + kva + kvb + o
        if kind == MAMBA:
            di = self.mamba_expand * d
            return (d * 2 * di + di * self.mamba_d_conv
                    + di * (2 * self.mamba_d_state + 2) + di * self.mamba_d_state
                    + di * d)
        if kind == MLSTM:
            di = 2 * d
            return d * 2 * di + 3 * di * di // 4 + di + di * 4 + di // 2 + di * d
        if kind == SLSTM:
            dh = d // max(self.n_heads, 1)
            rec = 4 * self.n_heads * dh * dh
            inp = 4 * d * d
            dff = max(128, ((int(d * 4 / 3) + 127) // 128) * 128)
            ffp = 3 * d * dff
            return rec + inp + ffp
        raise ValueError(kind)

    def _ffn_params(self, kind: str, active_only: bool = False) -> int:
        d = self.d_model
        dense = 3 * d * self.d_ff  # SwiGLU: up, gate, down
        if kind == FFN_NONE:
            return 0
        if kind == FFN_DENSE:
            return dense
        expert = 3 * d * self.d_ff_expert
        router = d * self.n_experts
        n_routed = self.top_k if active_only else self.n_experts
        moe = n_routed * expert + self.n_shared_experts * expert + router
        if kind == FFN_MOE_RESIDUAL:
            moe += dense
        return moe

    def _layer_params(self, idx: int, active_only: bool = False) -> int:
        return (self._mixer_params(self.mixer_kind(idx))
                + self._ffn_params(self.ffn_kind(idx), active_only)
                + 2 * self.d_model)  # norms

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_head=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=256,
        q_lora_rank=24 if cfg.q_lora_rank else 0,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        rope_head_dim=8 if cfg.kv_lora_rank else 64,
        v_head_dim=16 if cfg.v_head_dim else 0,
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        d_ff_expert=32 if cfg.d_ff_expert else 0,
        sliding_window=16 if cfg.local_global_period else cfg.sliding_window,
        mamba_d_state=8,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_frontend_tokens=8 if cfg.n_frontend_tokens else 0,
        first_k_dense=min(cfg.first_k_dense, 1),
        param_dtype="float32",
        opt_dtype="float32",
        compute_dtype="float32",
    )
    kw.update(overrides)
    return cfg.with_(**kw)
