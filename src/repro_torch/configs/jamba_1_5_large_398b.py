"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    n_experts=16, top_k=2, expert_d_ff=24576,
    attn_period=8,              # 1 attention layer per 8 (1:7 attn:mamba)
    ssm_d_state=16, ssm_expand=2, ssm_chunk=256,
    subquadratic=True,          # hybrid SSM: long_500k runs
)
