"""Config: gemma-7b (see repro_torch.configs.archs for the authoritative entry)."""

from repro_torch.configs import archs

CONFIG = archs.get("gemma-7b")
SMOKE = archs.smoke("gemma-7b")
