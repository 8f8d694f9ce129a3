"""GAN training of the tokenizer (mirror of `omnitokenizer_tpu.training`)."""
