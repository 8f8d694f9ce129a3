"""Host data-path code in C++, built on first use (mirror of
`omnitokenizer_tpu.native`)."""

from .build import available, crop_normalize_u8, get_lib, normalize_u8
