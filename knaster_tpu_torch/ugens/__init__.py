"""Port of knaster_tpu/ugens: UGen constants the ported slice needs."""
