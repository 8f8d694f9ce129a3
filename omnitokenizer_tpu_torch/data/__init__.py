"""Host-side data layers: datasets and loaders (mirror of `omnitokenizer_tpu.data`)."""
