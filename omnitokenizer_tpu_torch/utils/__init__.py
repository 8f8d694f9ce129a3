"""Checkpoints, weight inflation and media output (mirror of `omnitokenizer_tpu.utils`)."""
