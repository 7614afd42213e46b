"""Port of knaster_tpu/core: the UGen protocol."""
