"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ModelConfig``; the shape cells
(train_4k / prefill_32k / decode_32k / long_500k) are ``ShapeConfig``s.
``MODEL_FLOPS`` accounting (6*N*D convention + attention term, active-only
for MoE) lives here so the roofline analyzer, trainer logging and benchmarks
all agree on "useful FLOPs".
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Shape cells (assigned input-shape set for the LM family).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. Field defaults match a vanilla dense decoder."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # None => d_model // num_heads
    mlp_variant: str = "swiglu"     # swiglu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = True
    # Attention layout: repeating period of layer kinds.
    layer_pattern: Tuple[str, ...] = ("global",)   # global|local|rglru|ssm
    window_size: int = 4_096
    rope_theta: float = 10_000.0
    mrope: bool = False             # qwen2-vl 3D M-RoPE
    # MoE
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # RG-LRU (griffin/recurrentgemma)
    rnn_width: int = 0
    # Encoder-decoder (whisper): encoder stack + stubbed frontend frames.
    encoder_layers: int = 0
    encoder_seq: int = 0
    # Capability flags.
    supports_long_context: bool = False   # sub-quadratic path exists
    norm_eps: float = 1e-6
    source: str = ""                # provenance tag from the assignment

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if len(self.layer_pattern) and \
                self.num_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"layer_pattern period {len(self.layer_pattern)}")

    # ------------------------------------------------------------------
    # Parameter accounting.
    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding table and
        logits shard evenly over any mesh axis (whisper's 51865 is odd)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def d_head_total(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def d_kv_total(self) -> int:
        return self.num_kv_heads * self.head_dim

    def _mlp_params(self) -> int:
        mult = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
        return mult * self.d_model * self.d_ff

    def _moe_params(self, active: bool) -> int:
        e = self.num_experts_per_token if active else self.num_experts
        expert = 3 * self.d_model * self.moe_d_ff
        router = self.d_model * self.num_experts
        return e * expert + router

    def _attn_params(self) -> int:
        p = self.d_model * self.d_head_total            # Q
        p += 2 * self.d_model * self.d_kv_total         # K, V
        p += self.d_head_total * self.d_model           # O
        if self.qkv_bias:
            p += self.d_head_total + 2 * self.d_kv_total
        return p

    def _ssm_params(self) -> int:
        d_in = self.ssm_expand * self.d_model
        dt_rank = max(self.d_model // 16, 1)
        p = self.d_model * 2 * d_in                     # in_proj (x, z)
        p += d_in * self.ssm_conv                       # conv1d
        p += d_in * (dt_rank + 2 * self.ssm_state)      # x_proj
        p += dt_rank * d_in                             # dt_proj
        p += d_in * self.ssm_state + d_in               # A_log, D
        p += d_in * self.d_model                        # out_proj
        return p

    def _rglru_params(self) -> int:
        rw = self.rnn_width or self.d_model
        p = 2 * self.d_model * rw                       # in proj (x, gate)
        p += rw * self.ssm_conv if self.ssm_conv else 0  # temporal conv
        p += 2 * rw * rw // 16                          # block-diag gates
        p += 2 * rw                                     # a param + bias
        p += rw * self.d_model                          # out proj
        return p

    def _layer_params(self, kind: str, active: bool) -> int:
        norm = 2 * self.d_model
        if kind == "ssm":
            return self._ssm_params() + norm
        if kind == "rglru":
            return self._rglru_params() + self._mlp_params() + norm
        # attention layer (global or local)
        mlp = (self._moe_params(active) if self.num_experts
               else self._mlp_params())
        return self._attn_params() + mlp + norm

    def param_count(self, active: bool = False) -> int:
        period = self.layer_pattern
        per_period = sum(self._layer_params(k, active) for k in period)
        body = per_period * (self.num_layers // len(period))
        if self.encoder_layers:
            enc_layer = self._attn_params() + self._mlp_params() \
                + 2 * self.d_model
            cross = self._attn_params() + self.d_model
            body += self.encoder_layers * enc_layer + self.num_layers * cross
        embed = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            embed *= 2
        return body + embed

    # ------------------------------------------------------------------
    # MODEL_FLOPS (useful FLOPs) per shape cell.
    # ------------------------------------------------------------------
    def _attn_flops_per_token(self, kv_len: int, train: bool) -> float:
        """QK^T + AV matmul FLOPs per token per attention layer."""
        flops = 4.0 * self.num_heads * self.head_dim * kv_len
        if train:
            flops *= 0.5   # causal mask halves the average context
            flops *= 3.0   # fwd + bwd(2x)
        return flops

    def _effective_kv(self, kind: str, seq: int) -> int:
        return min(seq, self.window_size) if kind == "local" else seq

    def model_flops(self, shape: ShapeConfig) -> float:
        """Useful FLOPs for one step of the given shape cell.

        train: 6*N_active*tokens + attention term (fwd+bwd).
        prefill: 2*N_active*tokens + attention term (fwd only).
        decode: one new token per sequence against a seq_len KV cache.
        """
        n_active = self.param_count(active=True)
        n_embed = self.vocab_size * self.d_model
        n_body = n_active - n_embed * (1 if self.tie_embeddings else 2)
        # The LM head matmul is real compute; input embedding lookup is not.
        n_mm = n_body + n_embed

        period = self.layer_pattern
        reps = self.num_layers // len(period)
        attn_kinds = [k for k in period if k in ("global", "local")] * reps

        if shape.kind == "train":
            tokens = shape.seq_len * shape.global_batch
            flops = 6.0 * n_mm * tokens
            for k in attn_kinds:
                kv = self._effective_kv(k, shape.seq_len)
                flops += tokens * self._attn_flops_per_token(kv, train=True)
            return flops
        if shape.kind == "prefill":
            tokens = shape.seq_len * shape.global_batch
            flops = 2.0 * n_mm * tokens
            for k in attn_kinds:
                kv = self._effective_kv(k, shape.seq_len)
                flops += tokens * 0.5 * self._attn_flops_per_token(
                    kv, train=False)
            return flops
        # decode: one token per sequence.
        tokens = shape.global_batch
        flops = 2.0 * n_mm * tokens
        for k in attn_kinds:
            kv = self._effective_kv(k, shape.seq_len)
            flops += tokens * self._attn_flops_per_token(kv, train=False)
        return flops

    # ------------------------------------------------------------------
    def runnable_shapes(self) -> Tuple[str, ...]:
        """Shape cells this architecture can lower (skips documented in
        DESIGN.md Section 7)."""
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if self.supports_long_context:
            names.append("long_500k")
        return tuple(names)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        period = len(self.layer_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=max(period, 2 if period == 1 else period),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            moe_d_ff=64 if self.num_experts else 0,
            num_experts=min(self.num_experts, 8),
            num_experts_per_token=min(self.num_experts_per_token, 2),
            vocab_size=256,
            rnn_width=64 if self.rnn_width else 0,
            window_size=min(self.window_size, 32),
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_seq else 0,
        )


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, ModelConfig] = {}

ARCH_MODULES = (
    "recurrentgemma_9b", "qwen2_vl_7b", "falcon_mamba_7b", "whisper_base",
    "llama3_2_1b", "gemma3_12b", "gemma_2b", "qwen2_72b",
    "qwen3_moe_235b_a22b", "olmoe_1b_7b",
)


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    if len(_REGISTRY) >= len(ARCH_MODULES):
        return
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(_REGISTRY)}") from None


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def all_cells():
    """Every runnable (arch, shape) pair — the dry-run matrix."""
    _ensure_loaded()
    for arch in sorted(_REGISTRY):
        cfg = _REGISTRY[arch]
        for shape in cfg.runnable_shapes():
            yield arch, shape
