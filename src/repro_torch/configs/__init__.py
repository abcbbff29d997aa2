"""Model configurations of the port: ``get_config(arch_id)``."""
import importlib

_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "minicpm-2b": "minicpm_2b",
    "starcoder2-7b": "starcoder2_7b",
    "stablelm-1.6b": "stablelm_1_6b",
    "deepseek-67b": "deepseek_67b",
    "xlstm-350m": "xlstm_350m",
    "sru_timit": "sru_timit",
}

# the reference's other architectures, and the ROADMAP.md queue-1 item that
# ports their families
_WAITING = {
    "jamba-1.5-large-398b": "item 10 (hybrid Mamba/attention)",
    "internvl2-26b": "item 10 (VLM frontend)",
    "seamless-m4t-medium": "item 10 (encoder-decoder)",
}


def get_config(arch_id: str):
    if arch_id in _MODULES:
        return importlib.import_module(
            f"repro_torch.configs.{_MODULES[arch_id]}").CONFIG
    if arch_id in _WAITING:
        raise KeyError(f"arch {arch_id!r} is not ported yet: ROADMAP.md "
                       f"queue 1, {_WAITING[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_MODULES)}")
