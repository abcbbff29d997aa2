"""Model configurations of the port: ``get_config(arch_id)``, every
architecture of the reference package."""
import importlib

# the (arch x shape) sweep's architectures, in the reference's order
ARCH_IDS = (
    "jamba-1.5-large-398b",
    "granite-moe-1b-a400m",
    "qwen2-moe-a2.7b",
    "internvl2-26b",
    "minicpm-2b",
    "starcoder2-7b",
    "stablelm-1.6b",
    "deepseek-67b",
    "seamless-m4t-medium",
    "xlstm-350m",
)

_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "minicpm-2b": "minicpm_2b",
    "starcoder2-7b": "starcoder2_7b",
    "stablelm-1.6b": "stablelm_1_6b",
    "deepseek-67b": "deepseek_67b",
    "xlstm-350m": "xlstm_350m",
    "sru_timit": "sru_timit",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "internvl2-26b": "internvl2_26b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def get_config(arch_id: str):
    if arch_id in _MODULES:
        return importlib.import_module(
            f"repro_torch.configs.{_MODULES[arch_id]}").CONFIG
    raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_MODULES)}")
