"""xlstm-350m [ssm]: alternating mLSTM and sLSTM blocks. d_ff=0: blocks
carry their own up and down projections (ssm_expand), no separate MLP.
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    ssm_expand=2, slstm_every=2,
    subquadratic=True,
)
