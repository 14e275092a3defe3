"""seamless-m4t-large-v2 [audio]: the encoder-decoder multimodal backbone
(arXiv:2308.11596; hf).

24 decoder layers and 24 encoder layers, d_model 1024, 16 heads (16 KV
heads), d_ff 8192, vocab 256206, RoPE theta 10000.  The speech frontend
is a stub: the encoder takes precomputed frame embeddings of width
d_model, and every decoder block cross-attends to its output.
"""

from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,  # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    period=(LayerSpec("attn", "dense"),),
    rope_theta=10_000.0,
    optimizer="adamw",
    source="arXiv:2308.11596; hf",
)


def reduced() -> ArchConfig:
    """The CPU-sized seamless: 2 encoder and 2 decoder layers, d_model 64."""
    return FULL.replace(
        name="seamless-m4t-large-v2-smoke", n_layers=2, encoder_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        attention_chunk=32,
    )
