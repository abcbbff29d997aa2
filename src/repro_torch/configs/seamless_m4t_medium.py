"""seamless-m4t-medium [audio] — enc-dec; audio frontend is a stub supplying
precomputed frame embeddings. "12L" read as 12 encoder + 12 decoder layers
(the HF medium checkpoint has 12/12). [arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    is_encdec=True, n_dec_layers=12,
    frontend="audio", frontend_tokens=0, frontend_dim=1024,
)
