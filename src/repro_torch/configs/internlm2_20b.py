"""internlm2-20b [dense] — GQA.  48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92544 [arXiv:2403.17297; hf]."""

from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    period=(LayerSpec("attn", "dense"),),
    optimizer="adafactor",
    source="arXiv:2403.17297; hf",
)


def reduced() -> ArchConfig:
    """The CPU-sized internlm2-20b: 2 layers, d_model 96, 6/2 heads."""
    return FULL.replace(
        name="internlm2-20b-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=192, vocab=512, attention_chunk=32,
    )
