"""Port of knaster_tpu/graph: the graph, its compiler and the processor."""
