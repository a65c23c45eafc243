"""Config: deepseek-67b (see repro_torch.configs.archs for the authoritative entry)."""

from repro_torch.configs import archs

CONFIG = archs.get("deepseek-67b")
SMOKE = archs.smoke("deepseek-67b")
