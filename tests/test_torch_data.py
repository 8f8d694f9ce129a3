"""The port's host data layers against the JAX package's: on PNG and GIF
files written here, the port's VideoData / DataLoader / JointLoader give
the JAX package's batches bit for bit under the same args and seed (one
decode worker, so the order and the random crops are deterministic); the
finite-epoch eval semantics; the native normalize against numpy; the native
video decoder against imageio; each special dataset family (HDF5,
vtokens, frame folders, stft, HDF5 captions, CoinRun with captions)
routed to the JAX loader's first batch; the media grids."""

import argparse
import os

import numpy as np
import pytest

from omnitokenizer_tpu.data import loader as jax_loader
from omnitokenizer_tpu.utils import media as jax_media
from omnitokenizer_tpu_torch.data import loader as port_loader
from omnitokenizer_tpu_torch.data.video import load_video_frames
from omnitokenizer_tpu_torch.native import build as native
from omnitokenizer_tpu_torch.utils import media as port_media

from torch_port_util import write_coinrun, write_host_families, write_merge_table


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """12 PNG images (20x24) and 5 GIF clips (9 frames of 24x28), with lists."""
    import imageio.v3 as iio
    from PIL import Image

    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    img_lines, vid_lines = [], []
    for i in range(12):
        Image.fromarray(rng.randint(0, 255, (20, 24, 3), np.uint8)).save(root / f"im{i:02d}.png")
        img_lines.append(f"im{i:02d}.png\t{i % 4}")
    for i in range(5):
        cls = root / f"class{i % 2}"
        cls.mkdir(exist_ok=True)
        iio.imwrite(str(cls / f"clip{i}.gif"), rng.randint(0, 255, (9, 24, 28, 3), np.uint8),
                    loop=0)
        vid_lines.append(f"class{i % 2}/clip{i}.gif")
    (root / "imagenet_list.txt").write_text("\n".join(img_lines) + "\n")
    (root / "k600_list.txt").write_text("\n".join(vid_lines) + "\n")
    return root


def _args(root, lists, **kw):
    base = dict(data_path=[str(root)] * len(lists),
                train_datalist=[str(root / l) for l in lists],
                val_datalist=[str(root / l) for l in lists], batch_size=[3],
                resolution=16, sequence_length=5, num_workers=1, loader_type="joint")
    base.update(kw)
    return argparse.Namespace(**base)


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert list(a[k]) == list(b[k]), k


def _take(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


CASES = {
    "image_eval": (["imagenet_list.txt"], dict(), False),
    "image_train_resizecrop": (["imagenet_list.txt"], dict(resizecrop=True), True),
    "video_eval": (["k600_list.txt"], dict(), False),
    "video_train_resizecrop": (["k600_list.txt"], dict(resizecrop=True), True),
    "joint_ratio": (["imagenet_list.txt", "k600_list.txt"], dict(sample_ratio=[1.0, 2.0]), True),
    "joint_alternation": (["imagenet_list.txt", "k600_list.txt"],
                          dict(force_alternation=True, batch_size=[2, 1]), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batches_bit_equal_to_jax(files, case):
    lists, kw, train = CASES[case]
    args = _args(files, lists, **kw)
    got = _take(port_loader.VideoData(args, train=train), 6)
    want = _take(jax_loader.VideoData(args, train=train), 6)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("lists,bs", [(["imagenet_list.txt"], 5), (["k600_list.txt"], 3)],
                         ids=["image", "video"])
def test_one_epoch_with_the_tail_batch(files, lists, bs):
    args = _args(files, lists, batch_size=[bs])
    got = list(port_loader.VideoData(args, train=False, epochs=1))
    want = list(jax_loader.VideoData(args, train=False, epochs=1))
    assert [len(b["video"]) for b in got] == [len(b["video"]) for b in want]
    assert len(got[-1]["video"]) == 2  # the tail batch is kept
    for g, w in zip(got, want):
        _same(g, w)


class _IdxDataset:
    """Module-level (picklable): sample i is a constant plane of i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"video": np.full((2, 2), i, np.float32)}


def test_finite_epochs_match_jax():
    """tests/test_datasets.py's finite-epoch semantics, held to the JAX
    loader's: in order, the tail batch kept, then the iterator ends; the
    default cycles forever."""
    def run(mod, n, epochs, workers, mode="thread"):
        dl = mod.DataLoader(_IdxDataset(n), 2, shuffle=False, drop_last=False, epochs=epochs,
                            num_workers=workers, worker_mode=mode)
        return [b["video"][:, 0, 0].tolist() for b in dl]

    assert run(port_loader, 7, 1, 1) == run(jax_loader, 7, 1, 1) == [[0, 1], [2, 3], [4, 5], [6]]
    assert len(run(port_loader, 7, 2, 2)) == len(run(jax_loader, 7, 2, 2)) == 8
    dl = port_loader.DataLoader(_IdxDataset(3), 2, shuffle=True, num_workers=1)
    assert len(_take(dl, 5)) == 5
    # spawn-pool workers: the same batches, in submission order
    assert run(port_loader, 7, 1, 2, "process") == [[0, 1], [2, 3], [4, 5], [6]]


def test_shuffled_epochs_match_jax():
    kw = dict(batch_size=3, shuffle=True, seed=7, drop_last=True, num_workers=1, epochs=3)
    got = [b["video"][:, 0, 0].tolist() for b in port_loader.DataLoader(_IdxDataset(10), **kw)]
    want = [b["video"][:, 0, 0].tolist() for b in jax_loader.DataLoader(_IdxDataset(10), **kw)]
    assert got == want and len(got) == 9


def test_native_normalize_matches_numpy():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (3, 17, 21), dtype=np.uint8)
    np.testing.assert_allclose(native.normalize_u8(x), x.astype(np.float32) / 255.0 - 0.5,
                               atol=1e-7)
    v = rng.randint(0, 256, (4, 20, 24, 3), dtype=np.uint8)
    np.testing.assert_allclose(native.crop_normalize_u8(v, 2, 5, 16, 16),
                               v[:, 2:18, 5:21].astype(np.float32) / 255.0 - 0.5, atol=1e-7)
    with pytest.raises(ValueError, match="outside"):
        native.crop_normalize_u8(v, 8, 0, 16, 16)
    assert native.available(), "g++ is on this host: the native normalize must build"


def test_native_video_decoder_matches_imageio(files):
    if not native.video_available():
        pytest.skip("native video decoder not built (no libav here)")
    import imageio.v3 as iio

    path = str(files / "class0" / "clip0.gif")
    n, _, w, h = native.probe_video(path)
    assert (n, w, h) == (9, 28, 24)
    full = native.decode_video_window(path, 0, n, w, h)
    np.testing.assert_array_equal(full, np.asarray(iio.imread(path))[..., :3])
    np.testing.assert_array_equal(native.decode_video_window(path, 3, 4, w, h), full[3:7])
    frames, mask = load_video_frames(path, 12, "center", backend="native")
    ref, ref_mask = load_video_frames(path, 12, "center", backend="imageio")
    np.testing.assert_array_equal(frames, ref)
    np.testing.assert_array_equal(mask, ref_mask)
    assert mask.tolist() == [1] * 9 + [0] * 3


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """Files of each special family and a CoinRun directory (its name holds
    'coinrun'), with a BPE merge table."""
    root = tmp_path_factory.mktemp("families")
    out = write_host_families(root)
    write_coinrun(root / "coinrun_dir", n_games=4, n_frames=7)
    out["coinrun"] = str(root / "coinrun_dir")
    out["bpe"] = write_merge_table(root / "bpe_simple_vocab_16e6.txt")
    return out


ROUTES = {"vtokens": ("vtokens", dict(vtokens=True, resolution=6, spatial_length=4)),
          "image_folder": ("frames", dict(image_folder=True, sample_every_n_frames=2,
                                          sequence_length=3)),
          "stft": ("stft", dict(stft_data=True)),
          "text": ("text", dict(text_cond=True)),
          "hdf5": ("hdf5", dict()),
          "coinrun": ("coinrun", dict(text_cond=True, text_seq_len=24))}


@pytest.mark.parametrize("family", list(ROUTES))
def test_special_dataset_families_raise(files, families, family, monkeypatch):
    """Each special family routes as the JAX loader routes it (a family the
    port once refused): the first batch of the port's VideoData equals the
    JAX VideoData's, shuffled from the same seed, one decode worker."""
    from omnitokenizer_tpu.data import text_tokenizer as jax_text
    from omnitokenizer_tpu_torch.data import text_tokenizer

    monkeypatch.setattr(jax_text, "REFERENCE_VOCAB", families["bpe"])
    monkeypatch.setattr(text_tokenizer, "VOCAB_DIR", os.path.dirname(families["bpe"]))
    key, kw = ROUTES[family]
    args = _args(files, ["k600_list.txt"], **{"data_path": [families[key]], **kw})
    assert port_loader.special_family(args) == jax_family(family)
    port, ref = _take(port_loader.VideoData(args), 1)[0], _take(jax_loader.VideoData(args), 1)[0]
    _same(port, ref)
    assert len(port["video"]) == 3
    if family in ("text", "coinrun"):
        assert port["text"].shape == (3, 77 if family == "text" else 24)
    if family == "coinrun":
        assert port["path"] == ref["path"] and all(p.endswith(".json") for p in port["path"])


def jax_family(family: str) -> str:
    return {"stft": "stft_data", "text": "text_cond"}.get(family, family)


def test_media_grids_match_jax(tmp_path):
    vids = np.random.RandomState(0).rand(3, 4, 8, 8, 3).astype(np.float32) - 0.5
    np.testing.assert_array_equal(port_media.make_video_grid(vids),
                                  jax_media.make_video_grid(vids))
    np.testing.assert_array_equal(port_media.to_uint8(vids), jax_media.to_uint8(vids))
    port_media.save_video_grid(vids, str(tmp_path / "grid.gif"), fps=4)
    port_media.save_image_grid(vids[:, 0], str(tmp_path / "grid.png"))
    assert (tmp_path / "grid.gif").stat().st_size > 0 and (tmp_path / "grid.png").stat().st_size > 0
