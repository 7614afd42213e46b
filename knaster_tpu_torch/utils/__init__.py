"""Port of knaster_tpu/utils: sound-file IO (``wav``, ``codec``), numpy only."""
