"""internvl2-26b [vlm] — InternViT + InternLM2; ViT frontend is a stub that
supplies precomputed patch embeddings (assignment: backbone only).
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    frontend="patch", frontend_tokens=256, frontend_dim=6144,
)
