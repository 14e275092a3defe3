"""The architectures the port runs: the dense family and its reduced forms.

The JAX package registers ten; the port runs the four dense decoders
(yi-6b, granite-8b, internlm2-20b, stablelm-12b).  The others need
mixers, experts and encoders the port has not ported yet (ROADMAP A.8),
and asking for one raises ``NotImplementedError``.
"""

from . import granite_8b, internlm2_20b, stablelm_12b, yi_6b
from .base import ArchConfig

__all__ = ["ARCH_IDS", "FULL", "REDUCED", "REFERENCE_ARCH_IDS", "config"]

_MODULES = {"yi-6b": yi_6b, "granite-8b": granite_8b, "internlm2-20b": internlm2_20b,
            "stablelm-12b": stablelm_12b}

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
        NotImplementedError: ``name`` is not ported yet (ROADMAP A.8).
        ValueError: ``name`` is no architecture of the repository.

    Example:
        >>> config("yi-6b").d_model, config("internlm2-20b", smoke=True).d_model
        (4096, 96)
    """
    if name in FULL:
        return REDUCED[name]() if smoke else FULL[name]
    if name in REFERENCE_ARCH_IDS:
        raise NotImplementedError(
            f"{name} is not ported yet: the port runs {ARCH_IDS} "
            "(its other model families are ROADMAP A.8)"
        )
    raise ValueError(f"unknown architecture {name!r}; known: {list(REFERENCE_ARCH_IDS)}")
