"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 [hf:stabilityai/stablelm-2-12b; hf]."""

from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    period=(LayerSpec("attn", "dense"),),
    optimizer="adafactor",
    source="hf:stabilityai/stablelm-2-12b",
)


def reduced() -> ArchConfig:
    """The CPU-sized stablelm-12b: 2 layers, d_model 64, 4/2 heads, d_ff 160."""
    return FULL.replace(
        name="stablelm-12b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=512, attention_chunk=32,
    )
