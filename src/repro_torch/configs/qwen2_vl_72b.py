"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution (arXiv:2409.12191; hf).

80 layers, d_model 8192, 64 heads (GQA, 8 KV heads), d_ff 29568, vocab
152064.  The vision frontend is a stub: ``n_patches`` = 1024
precomputed patch embeddings (a 32 x 32 grid) are prepended to the text
tokens, and M-RoPE's sections (16, 24, 24) share the head_dim / 2 = 64
frequency slots among the (t, h, w) position streams.
"""

from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    period=(LayerSpec("attn", "dense"),),
    mrope_sections=(16, 24, 24),
    n_patches=1024,
    optimizer="adafactor",
    source="arXiv:2409.12191; hf",
)


def reduced() -> ArchConfig:
    """The CPU-sized qwen2-vl: 2 layers, d_model 64, 16 patches, sections
    (4, 2, 2) over head_dim 16."""
    return FULL.replace(
        name="qwen2-vl-72b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512, n_patches=16,
        mrope_sections=(4, 2, 2), attention_chunk=32,
    )
