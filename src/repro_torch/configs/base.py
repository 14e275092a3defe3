"""The port's own copy of the architecture configuration dataclasses.

``LayerSpec``, ``MoECfg``, ``MLACfg``, ``MambaCfg``, ``XLSTMCfg`` and
``ArchConfig`` carry the fields of the JAX package's ``configs/base.py``
that serving and training every architecture on one card read: the
dense, MoE, MLA, hybrid (Mamba), xLSTM, vision-language (patch
embeddings, M-RoPE) and encoder-decoder families, plus the distribution
knobs the mesh forms read (``tp_size``, ``microbatches_override``,
``gather_dtype``, ``moe_impl``, ``weights_resident_serve``, with the
reference's defaults) and the reference's cell shapes (``ShapeCfg``,
``SHAPES``).  ``param_count`` counts the port's own ``Model`` on the
meta device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["LayerSpec", "MoECfg", "MLACfg", "MambaCfg", "XLSTMCfg", "ArchConfig", "ShapeCfg",
           "SHAPES"]


@dataclass(frozen=True)
class LayerSpec:
    """One layer of a (possibly heterogeneous) period pattern."""

    mixer: str = "attn"  # attn | mamba | mlstm | slstm
    ffn: str = "dense"  # dense | moe | none


@dataclass(frozen=True)
class MoECfg:
    """Shared plus routed top-k experts with capacity-based dispatch."""

    n_experts: int
    top_k: int
    expert_ff: int
    n_shared: int = 0
    shared_ff: int = 0  # total ff of the shared expert(s)
    capacity_factor: float = 1.25
    router: str = "softmax"  # softmax | sigmoid (deepseek-v3)
    aux_loss_weight: float = 0.001
    # the mesh form: "tp" shards expert_ff over 'model' (one all-reduce
    # after combine), "ep" puts whole experts on 'model' ranks (two
    # all-to-alls); ``ArchConfig.moe_impl`` overrides it
    impl: str = "tp"


@dataclass(frozen=True)
class MLACfg:
    """Multi-head latent attention's ranks and head dims (DeepSeek-V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaCfg:
    """The Mamba-1 selective SSM mixer's sizes."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMCfg:
    """The xLSTM mixers' sizes: heads, the mLSTM's and the sLSTM FFN's
    projection factors, the causal conv width and the mLSTM chunk."""

    n_heads: int = 4
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    d_conv: int = 4
    chunk: int = 64  # chunkwise-parallel mLSTM chunk length


@dataclass(frozen=True)
class ArchConfig:
    """A model architecture: widths, layer pattern and executor knobs."""

    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    period: Tuple[LayerSpec, ...] = (LayerSpec(),)
    n_prefix: int = 0
    prefix_spec: Tuple[LayerSpec, ...] = ()
    attention: str = "gqa"  # gqa | mla
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    mamba: Optional[MambaCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    rope_theta: float = 1_000_000.0
    # qwen2-vl's M-RoPE: the (t, h, w) streams' shares of the D/2 slots
    mrope_sections: Optional[Tuple[int, int, int]] = None
    # > 0 adds a bidirectional encoder fed frame embeddings (seamless)
    encoder_layers: int = 0
    # precomputed patch embeddings prepended to the text (qwen2-vl)
    n_patches: int = 0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mtp: bool = False
    act_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    sub_quadratic: bool = False  # may run the reference's long_500k cell
    optimizer: str = "adamw"  # adamw | adafactor
    remat: str = "full"  # none | full | dots
    attention_chunk: int = 512  # chunked-attention tile
    attention_schedule: str = "folded"  # folded (simplex) | bb (baseline)
    # prefill attention executor: "auto" resolves through
    # autotune.choose_attn_impl; "flash" / "chunked" force a path,
    # "flash-folded" / "flash-bb" also pin the kernel schedule.
    attention_impl: str = "auto"
    # tensor-parallel width on the 'model' mesh axis: > 1 splits attention
    # heads and the experts over 'model'; 1 folds the axis into the data
    # axes (a small model needs no TP)
    tp_size: int = 16
    # overrides the shape's grad-accum microbatch count when > 0
    microbatches_override: int = 0
    # dtype the train step gathers parameters in ("bfloat16" halves the
    # gather's bytes; the optimizer updates the param_dtype master)
    gather_dtype: str = "float32"
    # MoE mesh form override: "" = MoECfg.impl; "ep" or "tp"
    moe_impl: str = ""
    # prefill and decode keep weights resident (sharded over 'model' only,
    # replicated over the data axes) instead of ZeRO-3; train keeps ZeRO-3
    weights_resident_serve: bool = True
    source: str = ""

    @property
    def hd(self) -> int:
        """Head dimension."""
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_periods(self) -> int:
        """Repetitions of ``period`` after the prefix layers."""
        body = self.n_layers - self.n_prefix
        if body < 0 or body % len(self.period):
            raise ValueError(f"{self.name}: {body} layers after the {self.n_prefix} prefix "
                             f"layers are not whole periods of {len(self.period)}")
        return body // len(self.period)

    def replace(self, **kw) -> "ArchConfig":
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Total parameters of the port's ``Model``, counted on the meta
        device (no memory is allocated).

        Example:
            >>> from repro_torch.configs.yi_6b import reduced
            >>> reduced().param_count()
            135488
        """
        from ..models.model import Model

        return sum(p.numel() for p in Model(self, device="meta").parameters())


@dataclass(frozen=True)
class ShapeCfg:
    """One cell's shape: sequence length, global batch, mode (``train``,
    ``prefill`` or ``decode``) and grad-accum microbatches."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode
    microbatches: int = 1


# The reference's cells.
SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train", microbatches=8),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}
