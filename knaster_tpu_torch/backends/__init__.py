"""Port of knaster_tpu/backends: offline (primary) and native-ring streaming."""

from .stream import AudioBackend, OfflineBackend, StreamBackend

__all__ = ["AudioBackend", "OfflineBackend", "StreamBackend"]
