"""The architectures the port runs and their reduced forms.

The JAX package registers ten; the port runs seven: the four dense
decoders (yi-6b, granite-8b, internlm2-20b, stablelm-12b), the MoE
models qwen2-moe-a2.7b and deepseek-v3-671b (MLA, dense prefix layers,
multi-token prediction) and the hybrid jamba-v0.1-52b (Mamba, attention
and MoE).  xlstm-350m, qwen2-vl-72b and seamless-m4t-large-v2 need
mixers, M-RoPE and an encoder the port has not ported yet (ROADMAP
A.8.3), and asking for one raises ``NotImplementedError``.
"""

from . import (deepseek_v3_671b, granite_8b, internlm2_20b, jamba_v01_52b, qwen2_moe_a27b,
               stablelm_12b, yi_6b)
from .base import ArchConfig

__all__ = ["ARCH_IDS", "FULL", "REDUCED", "REFERENCE_ARCH_IDS", "config"]

_MODULES = {"yi-6b": yi_6b, "granite-8b": granite_8b, "internlm2-20b": internlm2_20b,
            "stablelm-12b": stablelm_12b, "qwen2-moe-a2.7b": qwen2_moe_a27b,
            "deepseek-v3-671b": deepseek_v3_671b, "jamba-v0.1-52b": jamba_v01_52b}

FULL = {name: mod.FULL for name, mod in _MODULES.items()}

REDUCED = {name: mod.reduced for name, mod in _MODULES.items()}

ARCH_IDS = list(FULL)

# Every architecture of the JAX package, ported or not.
REFERENCE_ARCH_IDS = (
    "seamless-m4t-large-v2",
    "stablelm-12b",
    "yi-6b",
    "granite-8b",
    "internlm2-20b",
    "deepseek-v3-671b",
    "qwen2-moe-a2.7b",
    "qwen2-vl-72b",
    "jamba-v0.1-52b",
    "xlstm-350m",
)


def config(name: str, smoke: bool = False) -> ArchConfig:
    """The full (or, with ``smoke``, reduced) config of ``name``.

    Raises:
        NotImplementedError: ``name`` is not ported yet (ROADMAP A.8.3).
        ValueError: ``name`` is no architecture of the repository.

    Example:
        >>> config("yi-6b").d_model, config("internlm2-20b", smoke=True).d_model
        (4096, 96)
        >>> config("jamba-v0.1-52b").n_periods, config("deepseek-v3-671b").n_prefix
        (4, 3)
    """
    if name in FULL:
        return REDUCED[name]() if smoke else FULL[name]
    if name in REFERENCE_ARCH_IDS:
        raise NotImplementedError(
            f"{name} is not ported yet: the port runs {ARCH_IDS} "
            "(its other model families are ROADMAP A.8.3)"
        )
    raise ValueError(f"unknown architecture {name!r}; known: {list(REFERENCE_ARCH_IDS)}")
