"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].  61L d_model=7168 128H d_ff(expert)=2048
vocab=129280.  First 3 layers dense (d_ff=18432, HF config); MLA ranks
q_lora=1536 kv_lora=512 rope=64 nope=128 v=128 (HF config); 256
experts top-8, expert_ff=2048, 1 shared."""

from .base import ArchConfig, LayerSpec, MLACfg, MoECfg

FULL = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                     # dense prefix layers (HF config)
    vocab=129280,
    head_dim=192,                   # qk_nope(128) + qk_rope(64)
    attention="mla",
    mla=MLACfg(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
               qk_rope_dim=64, v_head_dim=128),
    moe=MoECfg(n_experts=256, top_k=8, expert_ff=2048, n_shared=1,
               shared_ff=2048, router="sigmoid"),
    n_prefix=3,
    prefix_spec=(LayerSpec("attn", "dense"),) * 3,
    period=(LayerSpec("attn", "moe"),),
    mtp=True,
    optimizer="adafactor",
    source="arXiv:2412.19437; hf",
)


def reduced() -> ArchConfig:
    """The CPU-sized deepseek-v3: 1 dense prefix layer and 2 MoE layers,
    d_model 64, 8 experts top-2, small MLA ranks."""
    return FULL.replace(
        name="deepseek-v3-671b-smoke", n_layers=3, n_prefix=1,
        prefix_spec=(LayerSpec("attn", "dense"),),
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        head_dim=24,
        mla=MLACfg(q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                   v_head_dim=16),
        moe=MoECfg(n_experts=8, top_k=2, expert_ff=32, n_shared=1, shared_ff=32,
                   router="sigmoid"),
        attention_chunk=32,
    )
