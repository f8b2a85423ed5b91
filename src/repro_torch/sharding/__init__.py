"""Data-parallel collectives on ``torch.distributed`` (port of
``repro/sharding``; the GSPMD partition rules have no counterpart)."""
from repro_torch.sharding import collectives  # noqa: F401
