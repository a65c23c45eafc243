"""Config: zamba2-2.7b (see repro_torch.configs.archs for the authoritative entry)."""

from repro_torch.configs import archs

CONFIG = archs.get("zamba2-2.7b")
SMOKE = archs.smoke("zamba2-2.7b")
