"""Config: starcoder2-15b (see repro_torch.configs.archs for the authoritative entry)."""

from repro_torch.configs import archs

CONFIG = archs.get("starcoder2-15b")
SMOKE = archs.smoke("starcoder2-15b")
