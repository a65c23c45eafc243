"""Config: deepseek-v3-671b (see repro_torch.configs.archs for the authoritative entry)."""

from repro_torch.configs import archs

CONFIG = archs.get("deepseek-v3-671b")
SMOKE = archs.smoke("deepseek-v3-671b")
