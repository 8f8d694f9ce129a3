"""Tokenizer model and its serving wrapper."""
