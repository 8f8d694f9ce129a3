"""Reconstruction evaluation CLI (mirror of `omnitokenizer_tpu.cli.vqgan_eval`,
the reference's vqgan_eval.py).

    python -m omnitokenizer_tpu_torch.cli.vqgan_eval --vqgan_ckpt CKPT \\
        --inference_type video --data_path DIR --val_datalist LIST ... [--device cpu]

image mode: input and reconstruction PNG trees, PSNR/SSIM, codebook usage,
  and rFID over the trees with pt_inception weights (--inception_path);
video mode: PSNR over frames, codebook usage, and rFVD from I3D logits with
  i3d_pretrained_400.pt (--i3d_path).
FVD and FID are computed only with real weights: random features give no
metric. VAE mode reconstructs a posterior sample and keeps no usage, as
the reference does. CKPT is a reference .ckpt, a .pt of the port or a
JAX .msgpack. The model runs on the card unless --device cpu; the
result is printed and written to <save>/result.json.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Iterable

import numpy as np
import torch

from . import args as A


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vqgan_eval")
    A.add_model_args(p)
    A.add_loss_args(p)
    A.add_data_args(p)
    A.add_device_arg(p)
    p.add_argument("--vqgan_ckpt", type=str, required=True)
    p.add_argument("--inference_type", type=str, default="image", choices=["image", "video"])
    p.add_argument("--save", type=str, default="./eval_out")
    p.add_argument("--dataset", type=str, default=None,
                   help="dataset tag: outputs nest under <save>/<dataset>")
    p.add_argument("--save_videos", action="store_true")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--train", action="store_true", help="evaluate on the train split")
    p.add_argument("--replacewithgt", type=int, default=None,
                   help="replace the first K frames of the reconstruction with the input "
                        "before FVD")
    p.add_argument("--infer_downsample", type=int, default=None,
                   help="downsample input and reconstruction by 1/N before the metrics "
                        "(video: antialiased bilinear; image: the dumped PNGs, Lanczos)")
    p.add_argument("--i3d_path", type=str, default=None)
    p.add_argument("--inception_path", type=str, default=None,
                   help="torch pt_inception-2015-12-05 state_dict for rFID")
    return p


def _to_u8(v: np.ndarray) -> np.ndarray:
    return np.clip((v + 0.5) * 255, 0, 255).astype(np.uint8)


def _read_png_tree(d: str) -> np.ndarray:
    from PIL import Image

    return np.stack([np.asarray(Image.open(os.path.join(d, f)), np.float32) / 255.0
                     for f in sorted(os.listdir(d))])


def _downsample_png(img: np.ndarray, n: int) -> np.ndarray:
    """The reference resizes the dumped PNGs with PIL's Lanczos filter
    (its vqgan_eval.py:207-218)."""
    from PIL import Image

    r = img.shape[0] // n
    return np.asarray(Image.fromarray(img).resize((r, r), Image.LANCZOS))


@torch.no_grad()
def evaluate(model, batches: Iterable[Dict[str, Any]], args) -> Dict[str, Any]:
    """Reconstruct every batch with `model` (an OmniTokenizerVQGAN) on its
    device and score it; returns the result dict (psnr, ssim,
    codebook_usage, fvd, fid, batches). `args` holds the CLI's eval flags:
    inference_type, save, max_batches, replacewithgt, infer_downsample,
    save_videos, i3d_path, inception_path."""
    from ..eval.frechet import frechet_distance
    from ..eval.metrics import psnr, ssim
    from ..training.loop import resize_bilinear, write_png

    cfg, device = model.cfg, model.device
    is_image = args.inference_type == "image"
    in_dir, out_dir = os.path.join(args.save, "inputs"), os.path.join(args.save, "recons")
    os.makedirs(in_dir, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)

    psnrs, ssims, used_codes = [], [], set()
    real_clips, fake_clips = [], []  # uint8 (B, T, H, W, C) for FVD
    n_batches = 0
    for bi, batch in enumerate(batches):
        if args.max_batches is not None and bi >= args.max_batches:
            break
        video = torch.as_tensor(np.asarray(batch["video"], np.float32)).to(device)
        if is_image and video.ndim == 5:
            video = video[:, 0]
        x = video.movedim(-1, 1)  # channels-first for the public API
        if cfg.use_vae:
            # a posterior sample's round trip, and no usage accounting (the
            # reference never counts usage under use_vae: Usage prints 0)
            rec = model.reconstruct(x, is_image=is_image)[0]
        else:
            enc = model.encode(x, is_image=is_image)
            rec = model.decode(enc, is_image=is_image)
            used_codes.update(torch.unique(enc).tolist())
        xin, xre = video, rec.float().movedim(1, -1)

        if is_image:
            psnrs.extend(psnr(xin, xre, data_range=1.0).tolist())
            ssims.extend(ssim(xin, xre, data_range=1.0).tolist())
            for d, arr in ((in_dir, xin), (out_dir, xre)):
                for i, img in enumerate(_to_u8(arr.cpu().numpy())):
                    if args.infer_downsample:
                        img = _downsample_png(img, args.infer_downsample)
                    write_png(os.path.join(d, f"b{bi:05d}_{i:03d}.png"), img)
        else:
            psnrs.extend(psnr(xin.flatten(0, 1), xre.flatten(0, 1)).tolist())
            real_v, fake_v = xin, xre
            if args.infer_downsample:  # the reference's vqgan_eval.py:121-135
                h, w = real_v.shape[2] // args.infer_downsample, real_v.shape[3] // args.infer_downsample
                real_v, fake_v = resize_bilinear(real_v, (h, w)), resize_bilinear(fake_v, (h, w))
            if args.replacewithgt is not None:  # the first K frames from the input
                k = args.replacewithgt
                fake_v = torch.cat([real_v[:, :k], fake_v[:, k:]], dim=1)
            real_v, fake_v = real_v.cpu().numpy(), fake_v.cpu().numpy()
            real_clips.append(_to_u8(real_v))
            fake_clips.append(_to_u8(fake_v))
            if args.save_videos:
                from ..utils.media import save_video_grid

                save_video_grid(fake_v, os.path.join(out_dir, f"recons_{bi}.gif"))
                save_video_grid(real_v, os.path.join(in_dir, f"gt_{bi}.gif"))
        n_batches += 1

    fid = None
    if is_image and args.inception_path:
        from ..eval.inception import compute_fid_features, load_inception

        inception, _ = load_inception(args.inception_path, device=device)
        fid = float(frechet_distance(compute_fid_features(_read_png_tree(in_dir), inception),
                                     compute_fid_features(_read_png_tree(out_dir), inception)))

    fvd = None
    if not is_image and real_clips:
        if args.i3d_path:
            from ..eval.i3d import compute_fvd_logits, load_i3d

            i3d, _ = load_i3d(args.i3d_path, device=device)
            fvd = float(frechet_distance(compute_fvd_logits(np.concatenate(real_clips), i3d),
                                         compute_fvd_logits(np.concatenate(fake_clips), i3d)))
        else:
            print("[vqgan_eval] no I3D weights (--i3d_path); skipping rFVD")

    return {"psnr": float(np.mean(psnrs)) if psnrs else None,
            "ssim": float(np.mean(ssims)) if ssims else None,
            "codebook_usage": len(used_codes) / cfg.n_codes,
            "fvd": fvd, "fid": fid, "batches": n_batches}


def main(argv=None) -> Dict[str, Any]:
    from ..data.loader import VideoData
    from ..models.wrapper import OmniTokenizerVQGAN

    args = A.normalize_precision(build_parser().parse_args(argv))
    # f32 stays f32 on the card: the indices and the cuDNN convolutions of
    # I3D and Inception must not round to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = A.tokenizer_config_from(args)
    model = OmniTokenizerVQGAN.load_from_checkpoint(args.vqgan_ckpt, cfg=cfg, device=args.device)
    if model.unfilled:
        print(f"[vqgan_eval] {len(model.unfilled)} tensors not in the checkpoint keep their "
              f"init values: {model.unfilled[:5]}")

    # epochs=1: the reference's eval iterates its finite loader once, in
    # order, tail batch included (its vqgan_eval.py:95-101)
    loader = VideoData(args, train=args.train, epochs=1)
    if args.dataset:
        args.save = os.path.join(args.save, args.dataset)
    os.makedirs(args.save, exist_ok=True)
    result = evaluate(model, iter(loader), args)
    print(json.dumps(result))
    with open(os.path.join(args.save, "result.json"), "w") as f:
        json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
