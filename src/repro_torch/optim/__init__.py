"""AdamW with float32 or blockwise-int8 moments (`adamw`)."""
from .adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]
