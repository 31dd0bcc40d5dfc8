"""Plain PyTorch ops of the port (ports of raw_ngp_tpu/ops)."""
