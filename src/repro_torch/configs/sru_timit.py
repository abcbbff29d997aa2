"""The paper's own model (Table 4): 4 Bi-SRU layers (n=550/direction) with 3
projection layers (p=256) in between, input FBANK features m=23, FC output to
1904 phone states — about 5.55 M MxV weights."""
from repro_torch.models.sru import SRUModelConfig

CONFIG = SRUModelConfig(
    name="sru_timit",
    input_dim=23,
    hidden=550,            # per direction
    proj=256,
    n_sru_layers=4,
    n_outputs=1904,
)
