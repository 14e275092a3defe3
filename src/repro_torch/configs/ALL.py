"""The architectures the port runs and their reduced forms.

The port runs every architecture the JAX package registers: the four
dense decoders (yi-6b, granite-8b, internlm2-20b, stablelm-12b), the MoE
models qwen2-moe-a2.7b and deepseek-v3-671b (MLA, dense prefix layers,
multi-token prediction), the hybrid jamba-v0.1-52b (Mamba, attention
and MoE), xlstm-350m (mLSTM and sLSTM blocks), the vision-language
qwen2-vl-72b (patch embeddings, M-RoPE) and the encoder-decoder
seamless-m4t-large-v2 (a bidirectional encoder, cross attention).
"""

from . import (deepseek_v3_671b, granite_8b, internlm2_20b, jamba_v01_52b, qwen2_moe_a27b,
               qwen2_vl_72b, seamless_m4t_large_v2, stablelm_12b, xlstm_350m, yi_6b)
from .base import ArchConfig

__all__ = ["ARCH_IDS", "FULL", "REDUCED", "config"]

_MODULES = {"yi-6b": yi_6b, "granite-8b": granite_8b, "internlm2-20b": internlm2_20b,
            "stablelm-12b": stablelm_12b, "qwen2-moe-a2.7b": qwen2_moe_a27b,
            "deepseek-v3-671b": deepseek_v3_671b, "jamba-v0.1-52b": jamba_v01_52b,
            "xlstm-350m": xlstm_350m, "qwen2-vl-72b": qwen2_vl_72b,
            "seamless-m4t-large-v2": seamless_m4t_large_v2}

FULL = {name: mod.FULL for name, mod in _MODULES.items()}

REDUCED = {name: mod.reduced for name, mod in _MODULES.items()}

ARCH_IDS = list(FULL)


def config(name: str, smoke: bool = False) -> ArchConfig:
    """The full (or, with ``smoke``, reduced) config of ``name``.

    Raises:
        ValueError: ``name`` is no architecture of the repository.

    Example:
        >>> config("yi-6b").d_model, config("internlm2-20b", smoke=True).d_model
        (4096, 96)
        >>> config("jamba-v0.1-52b").n_periods, config("deepseek-v3-671b").n_prefix
        (4, 3)
        >>> config("xlstm-350m").n_periods, config("qwen2-vl-72b").mrope_sections
        (3, (16, 24, 24))
        >>> config("seamless-m4t-large-v2", smoke=True).encoder_layers
        2
    """
    if name in FULL:
        return REDUCED[name]() if smoke else FULL[name]
    raise ValueError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
