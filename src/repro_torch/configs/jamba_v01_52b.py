"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2.  Period of 8: attention at index 4
(attn_layer_offset=4), MoE on odd layers (every 2, e_offset=1), the HF
Jamba layout."""

from .base import ArchConfig, LayerSpec, MambaCfg, MoECfg

_PERIOD = tuple(
    LayerSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

FULL = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    moe=MoECfg(n_experts=16, top_k=2, expert_ff=14336),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    period=_PERIOD,
    sub_quadratic=True,
    optimizer="adafactor",
    source="arXiv:2403.19887; hf",
)


def reduced() -> ArchConfig:
    """The CPU-sized jamba: one period of 8 layers, d_model 64, 4 experts."""
    return FULL.replace(
        name="jamba-v0.1-52b-smoke", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128,
        moe=MoECfg(n_experts=4, top_k=2, expert_ff=128),
        vocab=512, attention_chunk=32,
    )
