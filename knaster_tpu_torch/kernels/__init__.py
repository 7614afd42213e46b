"""Hand-written Hopper kernels, each with its plain torch version and launch count."""
