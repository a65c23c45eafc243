"""Config: mingru-lm (see repro_torch.configs.archs for the authoritative entry)."""

from repro_torch.configs import archs

CONFIG = archs.get("mingru-lm")
SMOKE = archs.smoke("mingru-lm")
