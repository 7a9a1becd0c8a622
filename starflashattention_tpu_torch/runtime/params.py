"""Model and attention configuration for the PyTorch port.

A copy of the JAX package's ``runtime/params.py`` (``AttentionConfig`` and
``ModelConfig`` with every field and preset) that needs neither JAX nor
PyTorch, so configs built on either side compare field for field. Fields
the port's first slice does not run (MoE, MLA, sliding windows, softcaps,
post-norms, embedding scale, non-silu activations) are still carried here;
``models/llama.check_supported`` rejects them at the model's entry points.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

QuantMode = Literal["none", "int8", "fp8"]


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Static attention-op configuration (frozen, hashable)."""

    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    # RoPE (reference: rotary tables + in-kernel transform, flash_attn.cu:161-257)
    rotary_dim: int | None = None  # None → full head_dim
    rope_base: float = 10000.0
    rope_style: str = "half"  # golden-model convention (testFlashDecoder.py:28-58)
    # kernel knobs (reference: kBlockN / num_splits, params.h:53-58)
    num_splits: int = 4
    block_k: int = 256
    batch_block: int | None = None  # sequences per decode grid cell; None = auto
    pages_per_compute_block: int = 4
    sm_scale: float | None = None
    quant_mode: QuantMode = "none"
    # Mistral-style sliding-window attention: each position attends only the
    # last `sliding_window` positions. None = full attention.
    sliding_window: int | None = None
    # StreamingLLM attention sinks: with a sliding window, the first
    # `attention_sinks` positions stay attendable forever.
    attention_sinks: int = 0

    def __post_init__(self):
        if self.num_q_heads % self.num_kv_heads:
            raise ValueError(
                f"num_q_heads {self.num_q_heads} not divisible by "
                f"num_kv_heads {self.num_kv_heads}"
            )
        if self.head_dim % 2:
            raise ValueError(f"head_dim must be even, got {self.head_dim}")

    @property
    def q_per_kv(self) -> int:
        return self.num_q_heads // self.num_kv_heads

    @property
    def rot_dim(self) -> int:
        return self.head_dim if self.rotary_dim is None else self.rotary_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Llama-class GQA transformer configuration (models/llama.py)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_q_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_base: float = 10000.0
    rope_style: str = "half"
    max_seq_len: int = 4096
    dtype: str = "bfloat16"
    quant_mode: QuantMode = "none"
    # Static KV quantization range (absmax calibration): scales cover
    # [-kv_calibration_scale, +kv_calibration_scale]. K/V projections of a
    # unit-variance residual stream are ~N(0,1), so ~5 sigma avoids clipping;
    # recalibrate per checkpoint (models/checkpoint.py loads real weights).
    kv_calibration_scale: float = 5.0
    num_splits: int = 4
    block_k: int = 256
    batch_block: int | None = None
    pages_per_compute_block: int = 4
    tie_embeddings: bool = False
    # Sliding-window (local) attention, e.g. Mistral-7B's 4096 — masks AND
    # prunes the decode kernel's KV fetch to the window band on BOTH cache
    # backends (ops/flash_decode._win_first; ops/paged_decode's band-shifted
    # page walk). The paged engine additionally reclaims out-of-window pages
    # (rolling-buffer KV, serving/engine.PagedEngine._reclaim_window).
    sliding_window: int | None = None
    # StreamingLLM attention sinks (https://arxiv.org/abs/2309.17453): with
    # a sliding window, the first `attention_sinks` positions stay
    # attendable forever — the bounded-memory infinite-context recipe. The
    # kernels prepend sink blocks to their (band-shifted) KV walks; the
    # paged engine keeps sink pages out of rolling-buffer reclamation.
    attention_sinks: int = 0
    # RoPE frequency scaling, as a hashable tuple (the config is a static
    # jit arg): ("llama3", factor, low_freq_factor, high_freq_factor,
    # original_max_position) for Llama-3.1-style warping, or
    # ("linear", factor) for classic position interpolation. None = off.
    rope_scaling: tuple | None = None
    # Fused-QKV projection bias (Qwen2-style; the reference ACCEPTS q/k/v
    # biases in its API but never applies them, flash_api.cpp:8-9 /
    # SURVEY.md §2.9h — here they are real).
    attention_bias: bool = False
    # Qwen3-style QK-norm: learned per-layer (head_dim,) RMSNorm on q and k
    # before RoPE (models/llama._apply_qk_norm).
    qk_norm: bool = False
    # Under TP (parallel/tp.py) the lm_head is VOCAB-SHARDED over the model
    # axis: each shard computes its (B, V/T) logit slice and the slices are
    # all-gathered — bit-identical to the replicated matmul but the per-chip
    # lm_head read drops T-fold (at 7B it is 262 MB/step, the largest
    # replicated stream in the TP decode step; the gathered logits are only
    # B·V·4 bytes). Set by tp._shard_cfg on the per-shard config; meaningless
    # (and ignored) without an axis_name. Tied embeddings keep the gather
    # path replicated, so the flag stays False there.
    lm_head_sharded: bool = False
    # Mixture-of-experts MLP (Mixtral-style). 0 = dense SwiGLU. With
    # num_experts > 0 the per-layer MLP is top-k routed over E experts
    # (models/llama._moe_mlp); under a mesh the experts shard over the
    # "model" axis (expert parallelism — parallel/tp.py treats the expert
    # axis the way dense TP treats the intermediate dim).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # --- DeepSeek-V2 MoE knobs ---------------------------------------------
    # Shared experts (DeepseekV2MoE, modeling_deepseek_v2): a dense SwiGLU of
    # intermediate n_shared_experts * intermediate_size runs on EVERY token
    # and its output adds to the routed sum. 0 = none (Mixtral/Qwen3).
    n_shared_experts: int = 0
    # DeepSeek first_k_dense_replace: the first k layers use a plain dense
    # SwiGLU (width dense_inter_size) instead of the routed MoE. The dense
    # weights live in a k-leading side stack (layers["dense_mlp"], closed
    # over like the quant dicts — the scan xs stay L-homogeneous) and a
    # lax.cond in _mlp_block picks the branch per traced layer index.
    first_k_dense: int = 0
    dense_inter_size: int | None = None
    # Router score convention: False = softmax over the TOP-K logits
    # (Mixtral; algebraically Qwen3's normalized top-k). True = DeepSeek's
    # greedy gate — softmax over ALL experts FIRST, then top-k, weights NOT
    # renormalized, times routed_scaling_factor.
    router_pre_softmax: bool = False
    routed_scaling_factor: float = 1.0
    # MLP gate activation: "silu" (Llama/Mistral/Qwen SwiGLU) or
    # "gelu_tanh" (Gemma GeGLU — HF's gelu_pytorch_tanh). Applied at every
    # MLP site (dense, quantized, fused Pallas, training twin).
    mlp_activation: str = "silu"
    # Gemma-style sqrt(hidden) scaling of the embedding output (HF applies
    # it inside the model, not the table — ours does too so tied lm_head
    # logits stay unscaled).
    embed_scale: bool = False
    # Gemma RMSNorm convention: HF computes x * (1 + w). The checkpoint
    # loader folds the +1 into the STORED weights when this is set, so the
    # runtime rms_norm (x * w) needs no branch; random init (w = 1.0)
    # already matches. Loader-only flag — no runtime consumer.
    norm_plus_one: bool = False
    # --- Gemma-2-class knobs ------------------------------------------------
    # tanh softcapping of attention scores (attn_logit_softcapping, e.g.
    # 50.0) — applied IN-KERNEL on the scaled scores (ops/flash_*). Requires
    # num_splits == 1 (the fused kernels).
    attn_softcap: float | None = None
    # tanh softcapping of the final lm logits (final_logit_softcapping, 30.0)
    final_softcap: float | None = None
    # attention score scale = query_scale ** -0.5 when set (Gemma-2's
    # query_pre_attn_scalar — decoupled from head_dim); None = 1/sqrt(D)
    query_scale: float | None = None
    # Alternating sliding/full attention layers (Gemma-2: pattern 2 — layer
    # L is SLIDING iff (L+1) % pattern != 0, matching HF's gemma layer_types
    # derivation). 1 = the window (if any) applies to every layer. Under
    # scan-over-layers a pattern > 1 makes the per-layer window a TRACED
    # scalar operand of the kernels (ops: *_dyn kernel twins).
    sliding_window_pattern: int = 1
    # Gemma-2 post-norms: params carry post_attn_norm/post_mlp_norm stacks
    # and each sublayer output is RMS-normed BEFORE its residual add.
    post_norms: bool = False
    # --- DeepSeek MLA (multi-head latent attention) -------------------------
    # The KV cache stores ONE shared latent row per token — [c_kv
    # (kv_lora_rank) | rope key (qk_rope_head_dim) | zero pad to a lane
    # multiple] — and attention runs ABSORBED in latent space on the
    # existing MQA kernels: q_abs = q_nope @ W_uk concatenated with the
    # roped q_pe attends the latent rows (scores exactly q.k of the
    # unabsorbed form by associativity), and the latent-space output maps
    # through W_uv. head_dim must be qk_nope_head_dim + qk_rope_head_dim
    # (the q/k head dim — the kernels' sm_scale comes from query_scale).
    mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int | None = None  # None = direct q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # W8A8 prefill: INT8-weight projections quantize activations per token
    # (dynamic) and run the int8 x int8 MXU path at PREFILL row counts —
    # measured 1.43x the bf16 MXU peak vs 0.95x for upcast weight-only
    # (ops/quant_matmul.quant_matmul_w8a8). Decode always stays weight-only
    # (HBM-bound; the int8 rate buys nothing). Opt-in: adds per-token
    # activation quant error (measured at 7B by benchmarks/quant_accuracy.py).
    w8a8_prefill: bool = False

    def __post_init__(self):
        if self.mla:
            if self.head_dim != self.qk_nope_head_dim + self.qk_rope_head_dim:
                raise ValueError(
                    f"MLA head_dim must be qk_nope+qk_rope "
                    f"({self.qk_nope_head_dim}+{self.qk_rope_head_dim}), "
                    f"got {self.head_dim}"
                )
            for flag, name in (
                (self.quant_mode != "none", "quantized KV"),
                (self.attention_bias, "attention_bias"),
                (self.qk_norm, "qk_norm"),
                (self.sliding_window is not None, "sliding_window"),
                (self.attn_softcap is not None, "attn_softcap"),
            ):
                if flag:
                    raise ValueError(f"MLA does not compose with {name} yet")
        if (self.n_shared_experts or self.first_k_dense
                or self.router_pre_softmax) and not self.num_experts:
            raise ValueError(
                "n_shared_experts / first_k_dense / router_pre_softmax are "
                "MoE knobs — they require num_experts > 0"
            )
        if self.first_k_dense and self.dense_inter_size is None:
            raise ValueError(
                "first_k_dense needs dense_inter_size (the dense-first "
                "layers' MLP width — DeepSeek's intermediate_size, distinct "
                "from the experts' moe_intermediate_size)"
            )
        if self.attention_sinks:
            if self.sliding_window is None:
                raise ValueError(
                    "attention_sinks require sliding_window (sinks only "
                    "matter when a window would evict the early positions)"
                )
            if self.attention_sinks < 0:
                raise ValueError("attention_sinks must be >= 0")

    def kv_cache_dims(self) -> tuple[int, int]:
        """(heads, row width) of the KV cache tables. MLA caches ONE shared
        latent row per token, padded to a 128-lane multiple."""
        if not self.mla:
            return self.num_kv_heads, self.head_dim
        raw = self.kv_lora_rank + self.qk_rope_head_dim
        return 1, -(-raw // 128) * 128

    def sm_scale(self) -> float | None:
        """Attention score scale for the kernels: ``query_scale ** -0.5``
        when set (Gemma-2), else None (kernels default to 1/sqrt(head_dim))."""
        return None if self.query_scale is None else self.query_scale**-0.5

    def attention(self) -> AttentionConfig:
        return AttentionConfig(
            num_q_heads=self.num_q_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            rope_base=self.rope_base,
            rope_style=self.rope_style,
            num_splits=self.num_splits,
            block_k=self.block_k,
            batch_block=self.batch_block,
            pages_per_compute_block=self.pages_per_compute_block,
            quant_mode=self.quant_mode,
            sliding_window=self.sliding_window,
            attention_sinks=self.attention_sinks,
        )

    @classmethod
    def llama_7b_gqa(cls, **overrides) -> "ModelConfig":
        """The 7B-GQA benchmark workload from BASELINE.json (Llama-7B dims
        with 8 KV heads)."""
        base = dict(
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=11008,
            num_layers=32,
            num_q_heads=32,
            num_kv_heads=8,
            head_dim=128,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def mistral_7b(cls, **overrides) -> "ModelConfig":
        """Mistral-7B-v0.1 geometry: Llama-7B-like GQA with a 4096-token
        sliding window and a 14336 MLP."""
        base = dict(
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_q_heads=32,
            num_kv_heads=8,
            head_dim=128,
            sliding_window=4096,
            max_seq_len=8192,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def qwen3_8b(cls, **overrides) -> "ModelConfig":
        """Qwen3-8B geometry: 36 layers, 32/8 GQA heads, QK-norm (per-head
        RMSNorm on q/k before RoPE), NO attention bias, rope theta 1e6."""
        base = dict(
            vocab_size=151936,
            hidden_size=4096,
            intermediate_size=12288,
            num_layers=36,
            num_q_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_base=1e6,
            max_seq_len=8192,
            qk_norm=True,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def gemma_7b(cls, **overrides) -> "ModelConfig":
        """Gemma-7B geometry: 28 layers, 16 MHA heads at head_dim 256, GeGLU
        MLP (gelu_tanh), sqrt(hidden)-scaled embeddings, tied lm_head.
        NOTE on norms: HF Gemma RMSNorm computes x * (1 + w); the checkpoint
        loader stores (1 + w) so the runtime rms_norm (x * w) is exact —
        random init (weights at 1.0) already matches."""
        base = dict(
            vocab_size=256000,
            hidden_size=3072,
            intermediate_size=24576,
            num_layers=28,
            num_q_heads=16,
            num_kv_heads=16,
            head_dim=256,
            rope_base=10000.0,
            max_seq_len=8192,
            rms_norm_eps=1e-6,
            tie_embeddings=True,
            mlp_activation="gelu_tanh",
            embed_scale=True,
            norm_plus_one=True,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def gemma2_9b(cls, **overrides) -> "ModelConfig":
        """Gemma-2-9B geometry: 42 layers, 16/8 GQA at head_dim 256,
        query_pre_attn_scalar 256, attention/final softcapping (50/30),
        alternating 4096-token sliding / full attention layers, GeGLU,
        scaled embeddings, tied lm_head, post-norms. num_splits=1: softcap
        runs in the fused kernels only."""
        base = dict(
            vocab_size=256000,
            hidden_size=3584,
            intermediate_size=14336,
            num_layers=42,
            num_q_heads=16,
            num_kv_heads=8,
            head_dim=256,
            rope_base=10000.0,
            max_seq_len=8192,
            rms_norm_eps=1e-6,
            tie_embeddings=True,
            mlp_activation="gelu_tanh",
            embed_scale=True,
            norm_plus_one=True,
            attn_softcap=50.0,
            final_softcap=30.0,
            query_scale=256.0,
            sliding_window=4096,
            sliding_window_pattern=2,
            post_norms=True,
            num_splits=1,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def phi3_medium(cls, **overrides) -> "ModelConfig":
        """Phi-3-medium geometry: 40 layers, 40/10 GQA at head_dim 128,
        fused qkv/gate_up checkpoints (loader reads them directly), longrope
        (su) scaling in long-context variants via
        rope_scaling=("longrope", orig, short_factors, long_factors)."""
        base = dict(
            vocab_size=32064,
            hidden_size=5120,
            intermediate_size=17920,
            num_layers=40,
            num_q_heads=40,
            num_kv_heads=10,
            head_dim=128,
            rope_base=10000.0,
            max_seq_len=4096,
            rms_norm_eps=1e-5,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def qwen2_7b(cls, **overrides) -> "ModelConfig":
        """Qwen2-7B geometry: 28/4 GQA heads, 3584 hidden, QKV bias,
        rope theta 1e6."""
        base = dict(
            vocab_size=152064,
            hidden_size=3584,
            intermediate_size=18944,
            num_layers=28,
            num_q_heads=28,
            num_kv_heads=4,
            head_dim=128,
            attention_bias=True,
            rope_base=1e6,
            max_seq_len=4096,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def llama31_8b(cls, **overrides) -> "ModelConfig":
        """Llama-3.1-8B: the 3.0 geometry with the long-context RoPE warp
        (factor 8 over the 8k-pretrained base; serve at any max_seq_len up
        to 128k that fits the cache budget)."""
        base = dict(max_seq_len=16384,
                    rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192))
        base.update(overrides)
        return cls.llama3_8b(**base)

    @classmethod
    def llama3_8b(cls, **overrides) -> "ModelConfig":
        """Llama-3-8B geometry: 32/8 GQA heads, 14336 MLP, 128k vocab,
        rope theta 5e5."""
        base = dict(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_q_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_base=5e5,
            max_seq_len=8192,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def mixtral_8x7b(cls, **overrides) -> "ModelConfig":
        """Mixtral-8x7B geometry: Mistral-7B attention (32/8 GQA heads) with
        an 8-expert top-2 MoE MLP (models/llama._moe_mlp)."""
        base = dict(
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_q_heads=32,
            num_kv_heads=8,
            head_dim=128,
            num_experts=8,
            num_experts_per_tok=2,
            rope_base=1e6,
            max_seq_len=8192,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def deepseek_v2_lite(cls, **overrides) -> "ModelConfig":
        """DeepSeek-V2-Lite geometry (15.7B total / 2.4B active): MLA with
        the direct q projection (no q_lora_rank), 64-expert top-6 MoE with
        2 shared experts, first layer dense (intermediate 10944), greedy
        softmax-all router. The absorbed latent cache stores 640 lanes/token
        (512 + 64, lane-padded) vs 2*16*192 = 6144 unabsorbed — 9.6x."""
        base = dict(
            vocab_size=102400,
            hidden_size=2048,
            intermediate_size=1408,  # routed expert width (moe_intermediate_size)
            num_layers=27,
            num_q_heads=16,
            num_kv_heads=1,
            head_dim=192,
            rope_base=10000.0,
            max_seq_len=8192,
            rms_norm_eps=1e-6,
            num_splits=1,
            mla=True,
            kv_lora_rank=512,
            q_lora_rank=None,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
            query_scale=192.0,
            num_experts=64,
            num_experts_per_tok=6,
            n_shared_experts=2,
            first_k_dense=1,
            dense_inter_size=10944,
            router_pre_softmax=True,
            routed_scaling_factor=1.0,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def tiny(cls, **overrides) -> "ModelConfig":
        """Small config for tests / CPU interpret mode."""
        base = dict(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_q_heads=4,
            num_kv_heads=2,
            head_dim=16,
            max_seq_len=128,
        )
        base.update(overrides)
        return cls(**base)
