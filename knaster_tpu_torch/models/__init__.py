"""Port of knaster_tpu/models: voice declarations."""
