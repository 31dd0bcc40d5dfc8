"""Occupancy-grid rendering (port of raw_ngp_tpu/render)."""
