"""Host-side datasets of pre-rendered depth maps: a directory of scanner
BMPs with CSV labels.

A numpy copy of ``sqtpu/data/datasets.py``:

* :func:`pack_bmp_dir` packs a directory's BMPs (sorted) once into a
  uint8 ``.npy``, memory-mapped from then on;
* :class:`DepthDataset` splits by index (the first ``train_split`` of the
  rows train, the rest validate: two independent index sets) and yields
  batches with the same ``np.random.default_rng(seed)`` shuffle as the
  JAX package, so the batches are the same to the bit;
* :func:`load_h5_dataset` reads a reference ``dataset.h5`` when h5py is
  installed.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from sqtpu_torch.data.bmp import read_bmp


def pack_bmp_dir(image_dir: str, pack_file: str | None = None) -> str:
    """Pack every ``*.bmp`` of a directory (sorted) into one uint8
    (N, H, W) ``.npy`` and return its path; an existing pack is kept."""
    pack_file = pack_file or os.path.join(image_dir, "dataset.npy")
    if os.path.exists(pack_file):
        return pack_file
    files = sorted(glob.glob(os.path.join(image_dir, "*.bmp")))
    if not files:
        raise FileNotFoundError(f"no .bmp files in {image_dir}")
    first = read_bmp(files[0])
    arr = np.lib.format.open_memmap(pack_file, mode="w+", dtype=np.uint8,
                                    shape=(len(files),) + first.shape)
    arr[0] = first
    for i, f in enumerate(files[1:], start=1):
        arr[i] = read_bmp(f)
    arr.flush()
    return pack_file


def load_h5_dataset(path: str, key: str = "sq") -> np.ndarray:
    """Read a reference ``dataset.h5`` (needs h5py)."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "h5py is not installed; convert the data with pack_bmp_dir "
            "or install h5py to read reference dataset.h5 files") from exc
    with h5py.File(path, "r") as f:
        return np.asarray(f[key])


class DepthDataset:
    """A memory-mapped depth-image dataset with an index train/val split."""

    def __init__(self, image_dir: str, labels: np.ndarray,
                 train_split: float = 0.9, pack_file: str | None = None):
        self.pack_file = pack_bmp_dir(image_dir, pack_file)
        self.images = np.load(self.pack_file, mmap_mode="r")
        self.labels = np.asarray(labels, dtype=np.float32)
        if len(self.images) != len(self.labels):
            raise ValueError(
                f"{len(self.images)} images vs {len(self.labels)} labels")
        n_train = int(train_split * len(self.labels))
        self.train_indices = np.arange(n_train)
        self.val_indices = np.arange(n_train, len(self.labels))

    def __len__(self):
        return len(self.labels)

    def batches(self, indices, batch_size: int, shuffle: bool = False,
                seed: int = 0, drop_remainder: bool = True):
        """Yield numpy (images (B, H, W, 1) float32 in [0, 1], labels
        (B, 12)) batches; each batch's rows are read in sorted order."""
        idx = np.array(indices)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        stop = len(idx) - (len(idx) % batch_size if drop_remainder else 0)
        for s in range(0, stop, batch_size):
            sel = np.sort(idx[s: s + batch_size])
            imgs = self.images[sel].astype(np.float32) / 255.0
            yield imgs[..., None], self.labels[sel]
