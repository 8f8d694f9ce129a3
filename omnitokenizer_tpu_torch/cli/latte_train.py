"""Latte training CLI (mirror of `omnitokenizer_tpu.cli.latte_train`, the
reference's Latte train.py): `dit_train`'s recipe on clip latents (B, 1 +
(T-1)//4, 8, 32, 32), with --use_image_num for joint image-video training.

    python -m omnitokenizer_tpu_torch.cli.latte_train --synthetic_data --results_dir RUN [--device cpu]
"""

from .dit_train import build_parser as _bp, main as _main


def build_parser():
    return _bp(video=True)


def main(argv=None):
    return _main(argv, video=True)


if __name__ == "__main__":
    main()
