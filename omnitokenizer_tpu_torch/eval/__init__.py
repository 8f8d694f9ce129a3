"""Reconstruction metrics and their feature extractors (mirror of `omnitokenizer_tpu.eval`)."""
