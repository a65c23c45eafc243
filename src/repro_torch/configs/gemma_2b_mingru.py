"""Config: gemma-2b-mingru (see repro_torch.configs.archs for the authoritative entry)."""

from repro_torch.configs import archs

CONFIG = archs.get("gemma-2b-mingru")
SMOKE = archs.smoke("gemma-2b-mingru")
