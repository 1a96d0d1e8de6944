"""The flattened-folder ImageNet dataset and its parallel host loader, the
twin of ``deepvision_tpu/data/folder.py``.

A directory of ``<synset>_<name>.JPEG`` files, labels from a synsets
file (one wnid a line, line i is label i), each sample decoded and
transformed (``data/transforms.py``) with a generator seeded by (seed,
epoch, index), so any worker count gives the same samples. The decode is
cv2's where cv2 is installed (BGR turned RGB, as JAX), else
``data/jpeg.decode_images`` on the dataset's device (nvJPEG on a card,
PIL on the CPU; ``"cuda"`` by default, which raises without a card),
brought back to host numpy for the transforms.
:class:`FolderLoader` maps the samples of each batch over a persistent
``spawn`` pool (never fork: the loader runs in processes whose threads
hold locks a forked child would inherit held).
"""

from __future__ import annotations

import multiprocessing as mp
from pathlib import Path

import numpy as np

from deepvision_tpu_torch.data import transforms as T

__all__ = ["load_synset_maps", "decode_file", "ImageNetFolderDataset",
           "FolderLoader"]


def load_synset_maps(synsets_file: str | Path):
    """synsets file (one wnid a line, index order) -> (wnid -> index,
    index -> wnid)."""
    wnids = [line.strip()
             for line in Path(synsets_file).read_text().splitlines()
             if line.strip()]
    return {w: i for i, w in enumerate(wnids)}, wnids


def decode_file(path: str | Path, device: str = "cpu") -> np.ndarray:
    """An image file -> uint8 (H, W, 3) RGB on the host: cv2 where it is
    installed, else ``data/jpeg.decode_images`` on ``device``."""
    cv2 = T.load_cv2()
    if cv2 is not None:
        img = cv2.imread(str(path))  # BGR
        if img is None:
            raise ValueError(f"cv2 cannot read {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    import torch

    from deepvision_tpu_torch.data.jpeg import decode_images, pack

    packed, offsets = pack([Path(path).read_bytes()])
    (img,) = decode_images(packed, offsets, torch.device(device))
    return img.cpu().numpy()


class ImageNetFolderDataset:
    def __init__(self, image_dir: str | Path, synsets_file: str | Path,
                 transform: T.Compose, *, seed: int = 0,
                 device: str = "cuda"):
        from deepvision_tpu_torch.device import resolve_device

        self.image_dir = Path(image_dir)
        self.wnid_to_idx, self.wnids = load_synset_maps(synsets_file)
        self.transform = transform
        self.seed = seed
        self.device = str(resolve_device(device))  # a string pickles
        # 'n01440764_10026.JPEG' -> its synset prefix
        self.files = sorted(self.image_dir.glob("*.JPEG"))
        self.labels = np.array(
            [self.wnid_to_idx[f.name.split("_")[0]] for f in self.files],
            np.int32)

    def __len__(self):
        return len(self.files)

    def load(self, i: int, epoch: int = 0) -> tuple[np.ndarray, int]:
        img = decode_file(self.files[i], self.device)
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + epoch) * 1_000_003 + i)
        return self.transform(rng, img), int(self.labels[i])


# the worker process's dataset, shipped once by the pool's initializer
_WORKER_DS: ImageNetFolderDataset | None = None


def _init_worker(ds: ImageNetFolderDataset):
    global _WORKER_DS
    _WORKER_DS = ds


def _load_one(args):
    i, epoch = args
    return _WORKER_DS.load(i, epoch)


class FolderLoader:
    """Batches of an :class:`ImageNetFolderDataset`, the samples of each
    loaded by ``num_workers`` spawned processes (kept for the loader's
    life; work items carry (index, epoch)), or in this process for one."""

    def __init__(self, dataset: ImageNetFolderDataset, batch_size: int,
                 *, shuffle: bool = True, num_workers: int = 8,
                 drop_remainder: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_remainder = drop_remainder
        self._pool = None

    def _get_pool(self):
        if self._pool is None:
            self._pool = mp.get_context("spawn").Pool(
                self.num_workers, initializer=_init_worker,
                initargs=(self.dataset,))
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            if self._pool is not None:
                self._pool.terminate()
        except Exception:
            pass  # interpreter teardown: best effort only

    def epoch(self, epoch: int = 0):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(epoch).shuffle(order)
        end = n - n % self.batch_size if self.drop_remainder else n
        pool = self._get_pool() if self.num_workers > 1 else None
        for s in range(0, end, self.batch_size):
            work = [(int(i), epoch) for i in order[s:s + self.batch_size]]
            if pool is not None:
                samples = pool.map(_load_one, work)
            else:
                samples = [self.dataset.load(i, e) for i, e in work]
            yield {"image": np.stack([im for im, _ in samples]),
                   "label": np.array([lb for _, lb in samples], np.int32)}
