"""Layers of the port (mirror of omnitokenizer_tpu.ops)."""
