"""yi-6b [dense] — llama-arch GQA.  32L d_model=4096 32H (GQA kv=4)
d_ff=11008 vocab=64000 [arXiv:2403.04652; hf]."""

from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    period=(LayerSpec("attn", "dense"),),
    optimizer="adamw",
    source="arXiv:2403.04652; hf",
)


def reduced() -> ArchConfig:
    """The CPU-sized yi-6b: 2 layers, d_model 64, 4/1 heads."""
    return FULL.replace(
        name="yi-6b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=512, attention_chunk=32,
    )
