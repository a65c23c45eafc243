"""Config: mamba2-370m (see repro_torch.configs.archs for the authoritative entry)."""

from repro_torch.configs import archs

CONFIG = archs.get("mamba2-370m")
SMOKE = archs.smoke("mamba2-370m")
