"""Training on the occupancy path (port of raw_ngp_tpu/train)."""
