"""xlstm-350m [ssm]: sLSTM and mLSTM blocks (arXiv:2405.04517).

24 layers, d_model 1024, 4 heads, vocab 50304.  ``d_ff`` is 0: the
blocks carry their own projections (the mLSTM's up-projection x2, the
sLSTM's gated FFN x4/3), as in the xLSTM paper.  Each period of 8 blocks
has an sLSTM at index 3 and mLSTMs elsewhere (7:1).  Its recurrent
state is of constant size.
"""

from .base import ArchConfig, LayerSpec, XLSTMCfg

_PERIOD = tuple(LayerSpec("slstm" if i == 3 else "mlstm", "none") for i in range(8))

FULL = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    xlstm=XLSTMCfg(n_heads=4, chunk=64),
    period=_PERIOD,
    sub_quadratic=True,
    optimizer="adamw",
    source="arXiv:2405.04517",
)


def reduced() -> ArchConfig:
    """The CPU-sized xlstm: one period of 8 blocks, d_model 64, chunk 16."""
    return FULL.replace(
        name="xlstm-350m-smoke", n_layers=8, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4,
        xlstm=XLSTMCfg(n_heads=4, chunk=16),
        attention_chunk=32,
    )
