"""granite-8b [dense] — llama-arch, code.  36L d_model=4096 32H (GQA
kv=8) d_ff=14336 vocab=49152 [arXiv:2405.04324; hf]."""

from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    period=(LayerSpec("attn", "dense"),),
    optimizer="adamw",
    source="arXiv:2405.04324; hf",
)


def reduced() -> ArchConfig:
    """The CPU-sized granite-8b: 2 layers, d_model 64, 4/2 heads."""
    return FULL.replace(
        name="granite-8b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512, attention_chunk=32,
    )
