"""Config: pixtral-12b (see repro_torch.configs.archs for the authoritative entry)."""

from repro_torch.configs import archs

CONFIG = archs.get("pixtral-12b")
SMOKE = archs.smoke("pixtral-12b")
