"""Batched loaders (mirror of `omnitokenizer_tpu.data.loader`): threaded or
process-pool prefetch, joint image+video loading, dataset-by-name dispatch.

In place of the reference's LightningDataModule and DistributedSampler
(its data.py:418-577): each process loads whole batches; a multi-process
run strides the index stream by (process_index, process_count).

Joint-loader semantics (the reference's omnitokenizer.py:528-539): each
step picks a dataset by weighted random choice (`sample_ratio`) or by
forced alternation.

Batches hold numpy arrays, channels-last; the caller moves them to its
device.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


def _collate(samples: List[Dict]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out


_worker_dataset = None


def _proc_init(ds_bytes: bytes) -> None:
    global _worker_dataset
    import pickle

    _worker_dataset = pickle.loads(ds_bytes)


def _proc_fetch(idxs):
    return _collate([_worker_dataset[int(i)] for i in idxs])


class DataLoader:
    """Shuffling, epoch-cycling, prefetching batch iterator.

    worker_mode:
      * 'thread' (default): GIL-sharing decode threads — fine when the codec
        releases the GIL or the host has spare cores;
      * 'process': a spawn-context multiprocessing pool (the analogue of
        torch DataLoader num_workers>0, data.py:512-535) — decode scales
        with cores independent of the GIL; the dataset must be picklable.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 1234, drop_last: bool = True,
                 num_prefetch: int = 4, num_workers: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 worker_mode: str = "thread", epochs: Optional[int] = None):
        if len(dataset) == 0:
            raise ValueError("DataLoader got an empty dataset — check data_folder/"
                             "data_list (video datasets walk '<root>/train|test' "
                             "when no list is given)")
        if drop_last and len(dataset) < batch_size * process_count:
            raise ValueError(
                f"dataset has {len(dataset)} samples < batch {batch_size} x "
                f"{process_count} processes; with drop_last this yields no batches")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.num_prefetch = num_prefetch
        self.num_workers = max(1, num_workers)
        self.process_index = process_index
        self.process_count = process_count
        assert worker_mode in ("thread", "process"), worker_mode
        self.worker_mode = worker_mode
        # None = cycle epochs forever (the TRAINING iterator contract: the
        # loop and validation passes pull `next()` for the whole run).
        # A finite count makes `iter()` terminate — eval CLIs pass epochs=1
        # to reproduce the reference's one-pass torch-DataLoader semantics
        # (vqgan_eval.py:102,170 iterates its finite loader exactly once).
        self.epochs = epochs

    def _index_stream(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            epoch += 1
            order = self.rng.permutation(n) if self.shuffle else np.arange(n)
            order = order[self.process_index::self.process_count]
            for i in range(0, len(order) - (self.batch_size - 1 if self.drop_last else 0),
                           self.batch_size):
                chunk = order[i:i + self.batch_size]
                if len(chunk) == self.batch_size or not self.drop_last:
                    yield chunk

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.worker_mode == "process":
            yield from self._iter_process()
            return
        idx_stream = self._index_stream()
        q: "queue.Queue" = queue.Queue(maxsize=self.num_prefetch)
        lock = threading.Lock()
        stop = threading.Event()

        done = object()  # per-worker end-of-stream sentinel (finite epochs)

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                with lock:
                    try:
                        idxs = next(idx_stream)
                    except StopIteration:
                        put(done)
                        return
                try:
                    batch = _collate([self.dataset[int(i)] for i in idxs])
                except BaseException as e:  # propagate to consumer
                    if not stop.is_set():
                        q.put(e)
                    return
                if not put(batch):
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            live = len(threads)
            while live:
                item = q.get()
                if item is done:
                    live -= 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # generator .close(): stop + JOIN the workers so no in-flight
            # decode outlives the iterator (a caller may delete the dataset
            # directory right after close — the shutdown race printed
            # spurious 'decode failed' retries otherwise)
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            for t in threads:
                t.join(timeout=10.0)

    def _iter_process(self) -> Iterator[Dict[str, Any]]:
        """Spawn-context pool with a bounded in-flight window: at most
        max(num_prefetch, num_workers) batches pending, results yielded in
        submission order (deterministic like the thread path); worker
        exceptions re-raise in the consumer."""
        import multiprocessing as mp
        import pickle
        from collections import deque

        ctx = mp.get_context("spawn")  # never fork a process that may own CUDA
        idx_stream = self._index_stream()
        window = max(self.num_prefetch, self.num_workers)
        with ctx.Pool(self.num_workers, initializer=_proc_init,
                      initargs=(pickle.dumps(self.dataset),)) as pool:
            pending: deque = deque()
            for idxs in itertools.islice(idx_stream, window):
                pending.append(pool.apply_async(_proc_fetch, (idxs,)))
            while pending:
                batch = pending.popleft().get()
                nxt = next(idx_stream, None)
                if nxt is not None:
                    pending.append(pool.apply_async(_proc_fetch, (nxt,)))
                yield batch

    def steps_per_epoch(self) -> int:
        return len(self.dataset) // (self.batch_size * self.process_count)


class JointLoader:
    """Multiple loaders, one batch per step, chosen by sample ratio or
    forced alternation (omnitokenizer.py:528-539)."""

    def __init__(self, loaders: Sequence[DataLoader],
                 sample_ratio: Optional[Sequence[float]] = None,
                 force_alternation: bool = False, seed: int = 1234):
        self.loaders = list(loaders)
        if sample_ratio is None:
            sample_ratio = [1.0] * len(self.loaders)
        total = float(sum(sample_ratio))
        self.probs = [r / total for r in sample_ratio]
        self.force_alternation = force_alternation
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        iters = [iter(l) for l in self.loaders]
        step = 0
        while True:
            if len(iters) == 1:
                k = 0
            elif self.force_alternation:
                k = step % len(iters)
            else:
                k = int(self.rng.choice(len(iters), p=self.probs))
            # training loaders cycle forever; a member only exhausts when it
            # was built with finite epochs (eval) — stop the joint stream then
            batch = next(iters[k], None)
            if batch is None:
                return
            yield batch
            step += 1


# the families whose samples carry no class: `label` -1 (vtokens has none)
CLASSLESS = ("coinrun", "image_folder", "stft_data", "smap_cond", "text_cond", "hdf5")


def special_family(args) -> Optional[str]:
    """The reference's 'sep' dataset family of `args` (its data.py:430-489),
    as the JAX package routes them: coinrun directories, pre-tokenized
    vtokens, frame folders, stft, smap/text HDF5 pairs and plain .h5 files;
    None when the image/video list routing applies."""
    import os.path as osp

    path0 = args.data_path if isinstance(args.data_path, str) else args.data_path[0]
    if osp.isdir(path0) and "coinrun" in path0.lower():
        return "coinrun"
    for flag in ("vtokens", "image_folder", "stft_data", "smap_cond", "text_cond"):
        if getattr(args, flag, None):
            return flag
    if path0.endswith((".h5", ".hdf5")):
        return "hdf5"
    return None


def text_seq_len(args) -> int:
    """The caption width of a text family: --text_seq_len, else 256 for
    CoinRun and 77 (CLIP's) for HDF5 captions."""
    return getattr(args, "text_seq_len", None) or (
        256 if special_family(args) == "coinrun" else 77)


def _special_dataset(args, train: bool):
    """The dataset of a special family (JAX data/loader.py:233-290), or None."""
    import os.path as osp

    family = special_family(args)
    if family is None:
        return None
    get = lambda n, d=None: getattr(args, n, d)  # noqa: E731
    path0 = args.data_path if isinstance(args.data_path, str) else args.data_path[0]
    if family == "coinrun":
        from .coinrun import CoinRunDataset

        # --text_cond on a coinrun directory: captions (get_text_desc)
        return CoinRunDataset(path0, get("asset_root") or osp.join(path0, "assets"),
                              sequence_length=args.sequence_length,
                              resolution=args.resolution, train=train,
                              get_text_desc=bool(get("text_cond")),
                              text_seq_len=text_seq_len(args), text_path=get("text_path"))
    from . import hdf5

    if family == "vtokens":
        return hdf5.HDF5DatasetVtokens(path0, args.sequence_length, train=train,
                                       resolution=args.resolution,
                                       spatial_length=get("spatial_length", args.resolution))
    if family == "image_folder":
        return hdf5.FrameDataset(path0, args.sequence_length, resolution=args.resolution,
                                 sample_every_n_frames=get("sample_every_n_frames", 1))
    if family == "stft_data":
        return hdf5.StftDataset(path0, sequence_length=args.sequence_length,
                                resolution=args.resolution)
    if family == "smap_cond":
        return hdf5.HDF5DatasetSmap(path0, get("data_path2"), args.sequence_length,
                                    train=train, resolution=args.resolution)
    if family == "text_cond":
        return hdf5.HDF5DatasetText(path0, args.sequence_length, train=train,
                                    resolution=args.resolution, text_len=text_seq_len(args))
    return hdf5.HDF5Dataset(path0, args.sequence_length, train=train,
                            resolution=args.resolution,
                            sample_every_n_frames=get("sample_every_n_frames", 1))


def VideoData(args, train: bool = True, process_index: int = 0,
              process_count: int = 1, epochs: Optional[int] = None):
    """Build loaders from an argparse-style namespace mirroring
    VideoData.add_data_specific_args (the reference's data.py:551-577):
    loader_type 'sep'/'joint', data_path / train_datalist / val_datalist
    lists, per-dataset batch_size; a special dataset family (`special_family`)
    is one DataLoader of batch_size[0], shuffled when training.

    `epochs=None` (default) cycles forever — the training/validation
    contract.  Eval CLIs pass epochs=1 for the reference's one-pass
    finite-DataLoader semantics (in-order, tail batch INCLUDED like torch
    drop_last=False)."""
    from .image import ImageDataset
    from .video import VideoDataset

    def listify(v):
        return v if isinstance(v, (list, tuple)) else [v]

    paths = listify(args.data_path)
    lists = listify(args.train_datalist if train else args.val_datalist)
    batch_sizes = listify(args.batch_size)
    if len(batch_sizes) == 1:
        batch_sizes = batch_sizes * len(paths)

    finite = epochs is not None
    lk = dict(num_workers=getattr(args, "num_workers", 2),
              worker_mode=getattr(args, "data_worker_mode", "thread"),
              process_index=process_index, process_count=process_count,
              epochs=epochs, drop_last=not finite)

    special = _special_dataset(args, train)
    if special is not None:
        return DataLoader(special, batch_sizes[0], shuffle=train, **lk)

    def _is_image_list(dlist: str) -> bool:
        # the first entry's extension is authoritative — a list NAME
        # containing 'image' must not misroute a video dataset; fall back to
        # the reference's dataset-name keys (data.py:481-508) only when the
        # list is unreadable or the extension is ambiguous
        try:
            with open(dlist) as f:
                for ln in f:
                    ln = ln.strip()
                    if not ln:
                        continue
                    ext = ln.split("\t")[0].rsplit(".", 1)[-1].lower()
                    if ext in ("jpg", "jpeg", "png", "bmp", "webp"):
                        return True
                    if ext in ("avi", "mp4", "webm", "mkv", "mov", "gif"):
                        return False
                    break
        except OSError:
            pass
        low = dlist.lower()
        if any(s in low for s in ("ucf", "k400", "k600", "sthv2", "moment")):
            return False
        return any(s in low for s in ("imagenet", "celeb", "ffhq", "image", "coco"))

    loaders = []
    for path, dlist, bs in zip(paths, lists, batch_sizes):
        image_like = _is_image_list(dlist)
        if image_like:
            ds = ImageDataset(path, dlist, train=train,
                              resolution=args.resolution,
                              resizecrop=getattr(args, "resizecrop", False))
        else:
            ds = VideoDataset(path, dlist,
                              fps=getattr(args, "fps", -1),
                              sequence_length=args.sequence_length,
                              train=train, resolution=args.resolution,
                              resizecrop=getattr(args, "resizecrop", False))
        loaders.append(DataLoader(ds, bs, shuffle=train, **lk))

    if len(loaders) == 1:
        return loaders[0]
    return JointLoader(loaders,
                       sample_ratio=getattr(args, "sample_ratio", None),
                       force_alternation=getattr(args, "force_alternation", False))
