"""The radiance field (port of raw_ngp_tpu/models)."""
