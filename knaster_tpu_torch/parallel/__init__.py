"""Port of knaster_tpu/parallel: voice banks."""
