"""Training datasets: the port's copy of the JAX package's
`data/datasets.py` (numpy host code; the frames come through
`data/video_reader.py`).

Parity targets:
  - WebVid video-caption loader (lvdm/data/webvid.py:13-202): csv metadata,
    frame_stride subsampling with random start, resize+center-crop, retry on
    broken videos;
  - DL3DV/DUSt3R paired-video loader (lvdm/data/DL3DV_dust3r.py:17-167):
    (video, video_cond, frameid) triplets where video_cond is the
    pre-rendered point-cloud video that becomes the c_concat conditioning
    (matching VIPLatentDiffusion.get_batch_input, ddpm3d.py:1251-1338), random
    condition frame, infinite retry-with-index-bump on decode failure.

Both yield numpy batches shaped for `training.make_train_step` after the
VAE and CLIP encoding.
"""

from __future__ import annotations

import csv
import os
import random
from typing import Dict, Iterator, List, Optional

import numpy as np

from viewcrafter_tpu_torch.data.video_reader import read_video, resize_crop, video_length


def _to_unit(frames: np.ndarray) -> np.ndarray:
    return frames.astype(np.float32) / 255.0 * 2.0 - 1.0


class WebVidDataset:
    """csv rows: videoid, page_dir, name (caption); videos under
    data_dir/page_dir/videoid.mp4 (or frame dirs)."""

    def __init__(self, meta_csv: str, data_dir: str, video_length: int = 16,
                 frame_stride: int = 4, resolution=(320, 512), seed: int = 0,
                 fixed_fps: Optional[float] = None):
        self.data_dir = data_dir
        self.video_length = video_length
        self.frame_stride = frame_stride
        self.resolution = resolution
        self.rng = random.Random(seed)
        with open(meta_csv) as f:
            self.rows = [r for r in csv.DictReader(f)]

    def __len__(self):
        return len(self.rows)

    def _path(self, row) -> str:
        rel = os.path.join(row.get("page_dir", ""), f"{row['videoid']}")
        for cand in (rel + ".mp4", rel):
            p = os.path.join(self.data_dir, cand)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(rel)

    def __getitem__(self, index: int) -> Dict:
        # retry loop over indices like the reference's `while True` guard
        for _ in range(len(self.rows)):
            row = self.rows[index % len(self.rows)]
            try:
                path = self._path(row)
                n = video_length(path)
                fs = self.frame_stride
                needed = (self.video_length - 1) * fs + 1
                if n < needed:
                    fs = max(1, n // self.video_length)
                    needed = (self.video_length - 1) * fs + 1
                start = self.rng.randint(0, max(0, n - needed))
                idx = np.arange(self.video_length) * fs + start
                frames = read_video(path, idx)
                frames = resize_crop(frames, *self.resolution)
                return {
                    "video": _to_unit(frames),
                    "caption": row.get("name", ""),
                    "frame_stride": fs,
                }
            except Exception:
                index += 1
        raise RuntimeError("no decodable videos in dataset")

    def __iter__(self) -> Iterator[Dict]:
        order = list(range(len(self.rows)))
        self.rng.shuffle(order)
        for i in order:
            yield self[i]


class PairedRenderDataset:
    """Parallel directories of (gt video, rendered point-cloud video) pairs:
    root/videos/<id>.mp4|/ and root/renders/<id>.mp4|/ with matching ids."""

    def __init__(self, root: str, video_length: int = 25, resolution=(576, 1024),
                 seed: int = 0, videos_subdir: str = "videos", renders_subdir: str = "renders",
                 rand_cond_frame: bool = True):
        self.videos_dir = os.path.join(root, videos_subdir)
        self.renders_dir = os.path.join(root, renders_subdir)
        self.video_length = video_length
        self.resolution = resolution
        self.rand_cond_frame = rand_cond_frame
        self.rng = random.Random(seed)
        ids = sorted(os.listdir(self.videos_dir))
        self.ids = [os.path.splitext(i)[0] for i in ids]

    def __len__(self):
        return len(self.ids)

    def _pair_paths(self, vid: str):
        def find(d):
            for cand in (os.path.join(d, vid + ".mp4"), os.path.join(d, vid)):
                if os.path.exists(cand):
                    return cand
            raise FileNotFoundError(vid)

        return find(self.videos_dir), find(self.renders_dir)

    def __getitem__(self, index: int) -> Dict:
        for _ in range(len(self.ids)):
            vid = self.ids[index % len(self.ids)]
            try:
                vp, rp = self._pair_paths(vid)
                n = min(video_length(vp), video_length(rp))
                if n < self.video_length:
                    raise ValueError("too short")
                start = self.rng.randint(0, n - self.video_length)
                idx = np.arange(self.video_length) + start
                video = resize_crop(read_video(vp, idx), *self.resolution)
                cond = resize_crop(read_video(rp, idx), *self.resolution)
                frameid = self.rng.randint(0, self.video_length - 1) if self.rand_cond_frame else 0
                return {
                    "video": _to_unit(video),
                    "video_cond": _to_unit(cond),
                    "frameid": frameid,
                }
            except Exception:
                index += 1
        raise RuntimeError("no decodable pairs in dataset")

    def __iter__(self) -> Iterator[Dict]:
        order = list(range(len(self.ids)))
        self.rng.shuffle(order)
        for i in order:
            yield self[i]


class PrefetchLoader:
    """Batches + background-thread prefetch (host decode overlaps device
    compute; the heavy decode work already runs in C inside libjpeg/ffmpeg)."""

    def __init__(self, dataset, batch_size: int, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = prefetch

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            batch: List[Dict] = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    q.put(self._collate(batch))
                    batch = []
            q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item

    @staticmethod
    def _collate(batch: List[Dict]) -> Dict:
        out: Dict = {}
        for k in batch[0]:
            vals = [b[k] for b in batch]
            if isinstance(vals[0], np.ndarray):
                out[k] = np.stack(vals)
            else:
                out[k] = np.asarray(vals) if not isinstance(vals[0], str) else vals
        return out
