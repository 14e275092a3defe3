"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].  24L d_model=2048 16H (GQA kv=16)
d_ff(expert)=1408 vocab=151936."""

from .base import ArchConfig, LayerSpec, MoECfg

FULL = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    moe=MoECfg(n_experts=60, top_k=4, expert_ff=1408, n_shared=4,
               shared_ff=5632),
    period=(LayerSpec("attn", "moe"),),
    optimizer="adamw",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)


def reduced() -> ArchConfig:
    """The CPU-sized qwen2-moe: 2 layers, d_model 64, 6 experts top-2."""
    return FULL.replace(
        name="qwen2-moe-a2.7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=64,
        moe=MoECfg(n_experts=6, top_k=2, expert_ff=64, n_shared=2, shared_ff=128),
        vocab=512, attention_chunk=32,
    )
