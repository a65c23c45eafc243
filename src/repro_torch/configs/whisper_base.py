"""Config: whisper-base (see repro_torch.configs.archs for the authoritative entry)."""

from repro_torch.configs import archs

CONFIG = archs.get("whisper-base")
SMOKE = archs.smoke("whisper-base")
