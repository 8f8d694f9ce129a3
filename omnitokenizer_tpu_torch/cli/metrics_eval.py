"""Generated-against-ground-truth metrics CLI (mirror of
`omnitokenizer_tpu.cli.metrics_eval`; the reference's
evaluation/fvd_external.py, common_metrics_on_video_quality's PSNR/SSIM,
pytorch-fid's directory FID and the OpenAI evaluator's batch metrics).

    python -m omnitokenizer_tpu_torch.cli.metrics_eval --gen_dir GEN --gt_dir GT \\
        [--i3d_path i3d_pretrained_400.pt] [--inception_path pt_inception.pt] \\
        [--metrics psnr,ssim,fvd,lpips,is,fid,sfid,prec_recall] [--device cpu]
    python -m omnitokenizer_tpu_torch.cli.metrics_eval --ref_npz REF.npz \\
        --sample_npz SAMPLE.npz --inception_path pt_inception.pt --metrics fid,sfid,prec_recall

Directory mode pairs the clips of --gen_dir and --gt_dir in sorted-name
order: .npz (key 'video', (T, H, W, C) or (C, T, H, W)), .npy, .gif and
video files, float in the --range convention or uint8. Batch mode takes
the evaluator's uint8 (N, H, W, 3) batches (the first array of each npz)
and computes the unpaired metrics only. The JSON keys are the JAX CLI's.

What the JAX CLI does, kept: the uint8 cast truncates ((g * 255) to uint8);
paired clips are cut to their common frame count, and the FVD clips are
cropped to the common (T, H, W) of all clips; with --range model, floats
are shifted by +0.5. LPIPS runs only with both its VGG16 backbone and its
heads (--lpips_vgg16_path or torchvision's cache, --lpips_lin_path; the
port's two flags beyond the JAX CLI's and --device), else it is skipped
with the JAX CLI's message. The models and the precision/recall distances
run on --device (the card by default); PSNR and SSIM too.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from . import args as A

CLIP_EXTS = ("npz", "npy", "gif", "mp4", "avi", "webm", "mkv")


def _load_clip(path: str, value_range: str, frames=None, sampling="center",
               resolution=None) -> np.ndarray:
    """-> float32 (T, H, W, C) in [0, 1]. Floats are read by --range: 'model'
    ([-0.5, 0.5], +0.5) or 'unit' ([0, 1]); uint8 / 255. A video file is
    decoded resized to `resolution`, then `frames` frames are taken at
    `sampling` (first/last/center), as fvd_external.py does."""
    if path.endswith(".npz"):
        arr = np.load(path)["video"]
    elif path.endswith(".npy"):
        arr = np.load(path)
    elif path.endswith((".mp4", ".avi", ".webm", ".mkv")):
        from ..data.video import _read_frames_imageio, _resize_frames, load_video_frames

        if frames:
            arr, valid = load_video_frames(path, num_frm=frames, strategy=sampling,
                                           height=resolution, width=resolution)
            if not valid.all():  # padded black frames would corrupt every metric
                raise ValueError(f"{path}: only {int(valid.sum())} decodable frames "
                                 f"< --frames {frames}")
        else:
            arr, _ = _read_frames_imageio(path)
            if resolution:
                arr = _resize_frames(arr, resolution, resolution)
    else:  # a gif or another clip imageio reads
        import imageio.v3 as iio

        arr = iio.imread(path)
    arr = np.asarray(arr)
    if arr.ndim == 3:  # one image (H, W, C)
        arr = arr[None]
    if arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = np.moveaxis(arr, 0, -1)  # (C, T, H, W) -> (T, H, W, C)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    arr = arr.astype(np.float32)
    if value_range == "model":
        arr = arr + 0.5
    return np.clip(arr, 0.0, 1.0)


def _clips(d: str, limit):
    paths = sorted(p for ext in CLIP_EXTS for p in glob.glob(os.path.join(d, f"*.{ext}")))
    return paths[:limit] if limit else paths


def _stacked(clips):
    """Every clip cropped to the common (T, H, W), stacked."""
    tmin = min(c.shape[0] for c in clips)
    hmin = min(c.shape[1] for c in clips)
    wmin = min(c.shape[2] for c in clips)
    return np.stack([c[:tmin, :hmin, :wmin] for c in clips])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("metrics_eval")
    ap.add_argument("--gen_dir", default=None)
    ap.add_argument("--gt_dir", default=None)
    ap.add_argument("--ref_npz", default=None,
                    help="evaluator-style reference image batch (uint8 (N, H, W, 3) under "
                         "arr_0)")
    ap.add_argument("--sample_npz", default=None, help="sample image batch (with --ref_npz)")
    ap.add_argument("--i3d_path", default=None, help="torch i3d_pretrained_400.pt for FVD")
    ap.add_argument("--inception_path", default=None,
                    help="torch pt_inception-2015-12-05 state_dict for FID/sFID/IS/"
                         "precision/recall")
    ap.add_argument("--metrics", default="psnr,ssim,fvd",
                    help="comma list from psnr,ssim,fvd,lpips,is,fid,sfid,prec_recall")
    ap.add_argument("--fvd_method", default="videogpt", choices=["videogpt", "styleganv"],
                    help="videogpt: plain 224 resize; styleganv: shorter-side resize + "
                         "center crop")
    ap.add_argument("--max_clips", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None,
                    help="sample exactly N frames per video file")
    ap.add_argument("--sampling", default="center", choices=["first", "last", "center"],
                    help="frame-window position when --frames is set")
    ap.add_argument("--resolution", type=int, default=None,
                    help="decode video files resized to this square size")
    ap.add_argument("--range", dest="value_range", default="model", choices=["model", "unit"],
                    help="float input convention: 'model' [-0.5, 0.5] or 'unit' [0, 1]")
    ap.add_argument("--save", default=None, help="write the result json here")
    ap.add_argument("--lpips_vgg16_path", default=None,
                    help="torchvision VGG16 state_dict for LPIPS (default: torchvision's cache)")
    ap.add_argument("--lpips_lin_path", default=None,
                    help="the reference's LPIPS heads (vgg.pth)")
    A.add_device_arg(ap)
    return ap


def main(argv=None) -> dict:
    from ..eval.metrics import psnr, ssim
    from ..models.wrapper import check_device

    args = build_parser().parse_args(argv)
    check_device(args.device)
    # f32 stays f32 on the card: the features and distances must not round to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    want = {m.strip() for m in args.metrics.split(",") if m.strip()}

    psnrs, ssims, gen_u8, gt_u8 = [], [], [], []
    if args.ref_npz or args.sample_npz:
        # the evaluator's batch mode: unpaired image batches, Inception metrics only
        if not (args.ref_npz and args.sample_npz):
            raise ValueError("--ref_npz and --sample_npz must be given together")
        if want & {"psnr", "ssim", "lpips", "fvd"}:
            raise ValueError("npz batch mode computes unpaired metrics only "
                             "(is,fid,sfid,prec_recall)")

        def load_npz(path):
            z = np.load(path)
            arr = z[z.files[0]]
            if arr.dtype != np.uint8 or arr.ndim != 4:
                raise ValueError(f"{path}: {arr.dtype} {arr.shape}, not uint8 (N, H, W, 3)")
            return arr[: args.max_clips] if args.max_clips else arr

        gt_u8, gen_u8 = [load_npz(args.ref_npz)], [load_npz(args.sample_npz)]
        n = len(gen_u8[0])
    else:
        if not (args.gen_dir and args.gt_dir):
            raise ValueError("--gen_dir and --gt_dir are required")
        gen_paths, gt_paths = _clips(args.gen_dir, args.max_clips), _clips(args.gt_dir,
                                                                            args.max_clips)
        if not (gen_paths and gt_paths):
            raise ValueError("empty input dirs")
        n = min(len(gen_paths), len(gt_paths))
        for gp, tp in zip(gen_paths[:n], gt_paths[:n]):
            g, t = (_load_clip(p, args.value_range, frames=args.frames, sampling=args.sampling,
                               resolution=args.resolution) for p in (gp, tp))
            tmin = min(g.shape[0], t.shape[0])
            g, t = g[:tmin], t[:tmin]
            gd, td = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (g, t))
            if "psnr" in want:
                psnrs.append(float(psnr(gd, td).mean()))
            if "ssim" in want:
                ssims.append(float(ssim(gd, td).mean()))
            gen_u8.append((g * 255).astype(np.uint8))  # truncates, as the JAX CLI does
            gt_u8.append((t * 255).astype(np.uint8))

    fvd = None
    if "fvd" in want and args.i3d_path:
        from ..eval.frechet import frechet_distance
        from ..eval.i3d import compute_fvd_logits, load_i3d, preprocess_videos_styleganv

        i3d, _ = load_i3d(args.i3d_path, device=device)
        both = _stacked(gen_u8 + gt_u8)  # every clip cropped to the common (T, H, W)
        pre = preprocess_videos_styleganv if args.fvd_method == "styleganv" else None
        lg = compute_fvd_logits(both[:len(gen_u8)], i3d, preprocess=pre)
        lt = compute_fvd_logits(both[len(gen_u8):], i3d, preprocess=pre)
        fvd = float(frechet_distance(lg, lt))
        del i3d

    lpips_val = None
    if "lpips" in want:
        # per-frame LPIPS averaged over clips; [0, 1] frames scaled to [-1, 1]
        from ..models.lpips import LPIPS, load_lpips_variables

        model, pretrained = load_lpips_variables(LPIPS(), args.lpips_vgg16_path,
                                                 args.lpips_lin_path)
        if pretrained:
            model = model.to(device).eval()
            vals = []
            with torch.no_grad():
                for g, t in zip(gen_u8, gt_u8):
                    a, b = (torch.from_numpy(x).to(device, torch.float32) / 255.0 * 2.0 - 1.0
                            for x in (g, t))
                    vals.append(float(model(a, b).mean()))
            lpips_val = float(np.mean(vals))
        else:
            print("[metrics_eval] no VGG backbone weights; skipping lpips")

    is_mean = is_std = fid = sfid = prec = recall = None
    inception_metrics = {"is", "fid", "sfid", "prec_recall"} & want
    if inception_metrics and args.inception_path:
        from ..eval.frechet import frechet_distance
        from ..eval.inception import (compute_fid_features, compute_inception_probs,
                                      compute_spatial_features, inception_score,
                                      load_inception)

        inception, pretrained = load_inception(args.inception_path, device=device)
        if pretrained:
            gen_frames = np.concatenate([c.astype(np.float32) / 255.0 for c in gen_u8])
            gt_frames = np.concatenate([c.astype(np.float32) / 255.0 for c in gt_u8])
            if "is" in want:
                is_mean, is_std = inception_score(compute_inception_probs(gen_frames, inception),
                                                  splits=1)
            if "fid" in want or "prec_recall" in want:
                fr = compute_fid_features(gt_frames, inception)
                ff = compute_fid_features(gen_frames, inception)
                if "fid" in want:
                    fid = float(frechet_distance(ff, fr))
                if "prec_recall" in want:
                    from ..eval.prec_recall import precision_recall

                    prec, recall = precision_recall(fr, ff, device=device)
            if "sfid" in want:
                sfid = float(frechet_distance(compute_spatial_features(gen_frames, inception),
                                              compute_spatial_features(gt_frames, inception)))
        else:
            print("[metrics_eval] inception weights unreadable; skipping "
                  + ",".join(sorted(inception_metrics)))

    result = {"clips": n,
              "psnr": float(np.mean(psnrs)) if psnrs else None,
              "ssim": float(np.mean(ssims)) if ssims else None,
              "fvd": fvd, "lpips": lpips_val,
              "is": is_mean, "is_std": is_std, "fid": fid, "sfid": sfid,
              "precision": prec, "recall": recall}
    print(json.dumps(result))
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        with open(args.save, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
