"""Model configuration dataclass (port of ``repro/configs/base.py``).

Field for field the same as the reference's ``ModelConfig``, so one
configuration describes the same model in both packages.  The port
serves all six families: ``dense``, ``moe``, ``ssm``, ``hybrid``,
``encdec`` and ``vlm``.  :class:`ShapeSpec` and the four assigned
shapes are the reference's too, the cells of the dry run
(``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.core.modes import NumericsConfig
from repro_torch.core.policy import NumericsPolicy, parse_policy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    # transformer backbone
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 4
    head_dim: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 512
    act: str = "silu"  # silu | gelu
    glu: bool = True  # gated MLP (SwiGLU/GeGLU)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma-style sqrt(d) embedding scale
    attn_logit_softcap: Optional[float] = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim
    capacity_factor: float = 1.25
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # hybrid (zamba2): shared attention block applied every k ssm blocks
    shared_attn_every: int = 0
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    frontend: Optional[str] = None  # 'audio' | 'vision' stub frontends
    frontend_dim: int = 0  # dim of precomputed frame/patch embeddings
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    # numerics + dtypes: a uniform NumericsConfig or a per-site
    # NumericsPolicy (see repro_torch.core.policy for the role taxonomy)
    numerics: Union[NumericsConfig, NumericsPolicy] = NumericsConfig(mode="bf16")
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    # misc
    sub_quadratic: bool = False  # supports 500k-context decode
    remat: bool = False
    kv_seq_tp: bool = False  # decode: shard KV-cache seq over TP axis
    moe_groups: int = 1  # MoE dispatch groups (set = data-parallel degree)
    expert_parallel: bool = False  # shard experts over the model axis (EP)
    flash_block: int = 0  # blockwise (flash) attention KV block; 0 = reference path

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def with_numerics(self, ncfg) -> "ModelConfig":
        """ncfg: NumericsConfig, NumericsPolicy, or a policy string /
        dict (parsed via repro_torch.core.policy.parse_policy)."""
        if not isinstance(ncfg, (NumericsConfig, NumericsPolicy)):
            ncfg = parse_policy(ncfg)
        return dataclasses.replace(self, numerics=ncfg)

    def reduced(self) -> "ModelConfig":
        """Smoke-test scale version of the same family."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_d_ff=64 if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            enc_layers=min(self.enc_layers, 2),
            dec_layers=min(self.dec_layers, 2),
            shared_attn_every=2 if self.shared_attn_every else 0,
            frontend_dim=128 if self.frontend else 0,
            mrope_sections=(4, 6, 6) if self.mrope_sections else None,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeSpec:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable_shapes(cfg: ModelConfig):
    """Which of the four assigned shapes apply to this architecture:
    every one, except the 524k-token decode for quadratic attention."""
    return [s for s in ALL_SHAPES if s.name != "long_500k" or cfg.sub_quadratic]
