"""Config: deepseek-moe-16b (see repro_torch.configs.archs for the authoritative entry)."""

from repro_torch.configs import archs

CONFIG = archs.get("deepseek-moe-16b")
SMOKE = archs.smoke("deepseek-moe-16b")
