"""Vision datasets — counterpart of ``paddle_tpu/vision/datasets.py``
(python/paddle/vision/datasets/ in Paddle), the port's own copy (host
numpy, safe in DataLoader workers).

``FakeImageDataset`` draws each index's image from
``np.random.default_rng(idx)`` as the reference does, so both packages
yield the same images. The downloaders raise: no dataset is fetched.
"""

from __future__ import annotations

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "VOC2012", "DatasetFolder", "ImageFolder", "FakeImageDataset"]


class FakeImageDataset(Dataset):
    """Synthetic image/label pairs (deterministic per index)."""

    def __init__(self, num_samples: int = 1024, image_shape=(3, 224, 224),
                 num_classes: int = 1000, transform=None, dtype="float32"):
        self.num_samples = int(num_samples)
        self.image_shape = tuple(image_shape)
        self.num_classes = int(num_classes)
        self.transform = transform
        self.dtype = dtype

    def __getitem__(self, idx):
        rng = np.random.default_rng(idx)
        img = rng.standard_normal(self.image_shape).astype(self.dtype)
        label = np.int64(rng.integers(0, self.num_classes))
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.num_samples


def _needs_download(name):
    class _D(Dataset):
        def __init__(self, *a, download=True, **k):
            raise RuntimeError(
                f"vision.datasets.{name}: this package downloads no "
                f"dataset — point a DatasetFolder-style paddle.io.Dataset "
                f"at local files, or use FakeImageDataset for pipeline "
                f"tests")
    _D.__name__ = name
    return _D


MNIST = _needs_download("MNIST")
FashionMNIST = _needs_download("FashionMNIST")
Cifar10 = _needs_download("Cifar10")
Cifar100 = _needs_download("Cifar100")
Flowers = _needs_download("Flowers")
VOC2012 = _needs_download("VOC2012")


class DatasetFolder(Dataset):
    """Filesystem class-per-directory dataset (numpy ``.npy`` loader by
    default; pass ``loader`` for image files)."""

    def __init__(self, root: str, loader=None, extensions=(".npy",),
                 transform=None, is_valid_file=None):
        import os
        self.root = root
        self.transform = transform
        self.loader = loader or (lambda p: np.load(p))
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                path = os.path.join(cdir, fname)
                ok = (is_valid_file(path) if is_valid_file
                      else fname.lower().endswith(tuple(extensions)))
                if ok:
                    self.samples.append((path, self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(target)

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    pass
