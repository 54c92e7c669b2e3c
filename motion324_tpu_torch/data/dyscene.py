"""Dyscene16k dataset + host-side prefetching loader; a copy of
``motion324_tpu/data/dyscene.py`` that reads a :class:`TrainConfig`.

Directory layout and sampling semantics follow the reference dataset
(reference: dataset/dyscene.py:14-383):

- ``root/pcds/{obj}_pointclouds/frame_*.npy`` per-frame (V, 3) vertices, plus
  ``faces.npy`` and ``uv_face_texture.npz`` (``face_uvs`` (F,3,2) +
  ``texture_array`` (H,W,3));
- ``root/all_images/{obj}_images/camera_{0..14}/frame_*.jpg`` renders;
- a 12-frame window sampled with skip in {1, 2, 4} at weights 0.4/0.4/0.2
  (:76-127), random camera (:187);
- defensive resampling: any missing/corrupt/NaN data re-draws a random index
  (:167-169, 238-249, 278-313);
- per-sample tracking of ``num_shape_samples`` (frame-0 shape) and
  ``num_pcd_samples`` (full sequence supervision) textured surface points.

The loader is a thread-pool prefetcher that assembles numpy batches; the
trainer copies them to the device. PIL is imported only where images are
read.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import re
import threading

import numpy as np

from motion324_tpu_torch.config import TrainConfig
from motion324_tpu_torch.data.tracking import track_points

__all__ = ["DysceneDataset", "PrefetchLoader", "collate"]

_FRAME_RE = re.compile(r"frame_(\d+)\.(npy|jpg|png)$")


def _frame_number(name: str) -> int:
    m = _FRAME_RE.search(name)
    return int(m.group(1)) if m else -1


def _sorted_frames(directory: str, exts=(".npy",)) -> list[str]:
    if not os.path.isdir(directory):
        return []
    names = [n for n in os.listdir(directory)
             if n.startswith("frame_") and n.endswith(exts)]
    names.sort(key=_frame_number)
    return [os.path.join(directory, n) for n in names]


class DysceneDataset:
    """Map-style dataset yielding host numpy sample dicts."""

    NUM_CAMERAS = 15
    SKIP_OPTIONS = ((1, 0.4), (2, 0.4), (4, 0.2))

    def __init__(self, cfg: TrainConfig, pcd_subdir: str = "pcds", seed: int = 0):
        t = cfg
        self.root = t.dataset_path
        self.pcd_dir = os.path.join(self.root, pcd_subdir)
        self.image_dir = os.path.join(self.root, "all_images")
        self.frames = int(t.frames)
        self.replica = int(t.replica)
        self.num_shape_samples = int(t.num_shape_samples)
        self.num_pcd_samples = int(t.num_pcd_samples)
        self.rng = np.random.RandomState(seed)

        lst = t.train_lst
        if lst and os.path.exists(lst):
            with open(lst) as f:
                names = [line.strip() for line in f if line.strip()]
        else:  # fall back to directory scan
            names = sorted(d[:-len("_pointclouds")]
                           for d in os.listdir(self.pcd_dir)
                           if d.endswith("_pointclouds")) \
                if os.path.isdir(self.pcd_dir) else []
        begin = int(t.dataset_begin)
        end = int(t.dataset_end)
        names = names[begin:None if end == -1 else end]
        if not names:
            raise RuntimeError(f"no objects found under {self.root}")
        self.obj_names = names

    def __len__(self) -> int:
        return len(self.obj_names) * self.replica

    # ------------------------------------------------------------------ #
    def _choose_frame_indices(self, total: int) -> list[int] | None:
        if total < self.frames:
            return None
        options = []
        for skip, weight in self.SKIP_OPTIONS:
            span = (self.frames - 1) * skip + 1
            if total >= span:
                options.append((skip, weight, span))
        if not options:
            return None
        weights = np.array([w for _, w, _ in options])
        skip, _, span = options[self.rng.choice(len(options),
                                                p=weights / weights.sum())]
        start = self.rng.randint(0, total - span + 1)
        return [start + i * skip for i in range(self.frames)]

    def _load_object(self, obj_name: str):
        pcd_dir = os.path.join(self.pcd_dir, obj_name + "_pointclouds")
        cam = f"camera_{self.rng.randint(self.NUM_CAMERAS)}"
        img_dir = os.path.join(self.image_dir, obj_name + "_images", cam)

        pcd_files = _sorted_frames(pcd_dir, (".npy",))
        img_files = _sorted_frames(img_dir, (".jpg", ".png"))
        total = min(len(pcd_files), len(img_files))
        idxs = self._choose_frame_indices(total)
        if idxs is None:
            return None

        faces = np.load(os.path.join(pcd_dir, "faces.npy"))
        uv_path = os.path.join(pcd_dir, "uv_face_texture.npz")
        if not os.path.exists(uv_path):
            return None
        uv_data = np.load(uv_path)
        face_uvs = uv_data["face_uvs"]
        texture = uv_data["texture_array"]

        from PIL import Image
        frames, verts = [], []
        for i in idxs:
            img = np.asarray(Image.open(img_files[i]).convert("RGB"),
                             dtype=np.float32) / 255.0
            frames.append(img)
            verts.append(np.load(pcd_files[i]))
        video = np.stack(frames).astype(np.float32)
        vertex_frames = np.stack(verts).astype(np.float32)

        seed = int(self.rng.randint(1 << 31))
        shape_pts, shape_normals, shape_rgbs, _ = track_points(
            vertex_frames[:1], faces, self.num_shape_samples,
            face_uvs, texture, seed=seed)
        pts, normals, rgbs, _ = track_points(
            vertex_frames, faces, self.num_pcd_samples,
            face_uvs, texture, seed=seed + 1)

        for arr in (shape_pts, shape_normals, pts, normals):
            if not np.isfinite(arr).all():
                return None

        return {
            "obj_name": obj_name,
            "rgb_video": video,
            "point_clouds": pts,
            "ref_shape_pcd": shape_pts[0],
            "ref_shape_normals": shape_normals[0],
            "ref_shape_rgbs": shape_rgbs[0],
            "ref_pcd": pts[0],
            "ref_normal": normals[0],
            "ref_rgb": rgbs[0],
        }

    def __getitem__(self, idx: int):
        for _ in range(16):  # defensive resampling, bounded
            obj = self.obj_names[idx % len(self.obj_names)]
            try:
                sample = self._load_object(obj)
            except Exception:
                sample = None
            if sample is not None:
                return sample
            idx = self.rng.randint(len(self))
        raise RuntimeError("could not draw a valid sample after 16 attempts")


def collate(samples: list[dict]) -> dict:
    """Stack numeric keys into (B, ...) arrays; keep strings as lists.

    Raises with a per-key shape diagnostic on mismatch (reference
    dataset/dyscene.py:331-383). An optional per-sample ``edge_indices``
    (2, E) graph is batched as one disjoint graph: each sample's node ids
    shift by its offset in the batch (node count = ``point_clouds`` points)
    and the edge lists concatenate to (2, B*E) (reference :368-381)."""
    out: dict = {}
    for key in samples[0]:
        if key == "edge_indices":
            n = samples[0]["point_clouds"].shape[1]
            out[key] = np.concatenate(
                [s[key] + i * n for i, s in enumerate(samples)], axis=1)
            continue
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            shapes = {v.shape for v in vals}
            if len(shapes) > 1:
                raise ValueError(f"collate: key {key!r} has mismatched shapes "
                                 f"{sorted(shapes)}")
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class PrefetchLoader:
    """Thread-pool batch prefetcher: yields collated numpy batches.

    The host-side replacement for the reference's torch DataLoader with
    ``num_workers``/``prefetch_factor`` (reference train.py:58-74). Samples are
    drawn in shuffled epochs; worker threads overlap PIL/numpy decode with
    device compute.
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 prefetch: int = 2, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.drop_last = drop_last

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            epoch = 0
            while not stop.is_set():
                order = rng.permutation(len(self.dataset))
                for i in range(0, len(order), self.batch_size):
                    idxs = order[i:i + self.batch_size]
                    if self.drop_last and len(idxs) < self.batch_size:
                        break
                    futures = [pool.submit(self.dataset.__getitem__, int(j))
                               for j in idxs]
                    batch = collate([f.result() for f in futures])
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                epoch += 1

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            pool.shutdown(wait=False)
