"""Latte sampling CLI (mirror of `omnitokenizer_tpu.cli.latte_sample`, the
reference's Latte sample/sample_ddp.py): `dit_sample` on clips, CFG on the
first 4 channels, decoded through the OmniTokenizer VAE into mp4s.

    python -m omnitokenizer_tpu_torch.cli.latte_sample --ckpt RUN/state_*.pt [--device cpu]
"""

from .dit_sample import build_parser as _bp, main as _main


def build_parser():
    return _bp(video=True)


def main(argv=None):
    return _main(argv, video=True)


if __name__ == "__main__":
    main()
