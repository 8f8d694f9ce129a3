"""Command-line entry points (mirror of `omnitokenizer_tpu.cli`)."""
