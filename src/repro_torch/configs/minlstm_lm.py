"""Config: minlstm-lm (see repro_torch.configs.archs for the authoritative entry)."""

from repro_torch.configs import archs

CONFIG = archs.get("minlstm-lm")
SMOKE = archs.smoke("minlstm-lm")
