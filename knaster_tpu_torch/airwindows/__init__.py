"""Port of knaster_tpu/airwindows: the airwindows plugin tier (Galactic)."""

from .galactic import Galactic

__all__ = ["Galactic"]
