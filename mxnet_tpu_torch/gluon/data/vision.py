"""Vision datasets (reference: python/mxnet/gluon/data/vision.py).

Counterpart of ``mxnet_tpu/gluon/data/vision.py``. The reference downloads
MNIST/CIFAR from the web; these read the same idx/binary files from under
``root`` and download nothing: a missing file raises and names itself.
``SyntheticImageDataset`` is an offline stand-in with a learnable class
structure. Arrays go to the ``with`` scope at construction, else the card.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ... import ndarray as nd
from ...base import MXNetError
from ... import image, recordio
from .dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset",
           "SyntheticImageDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


class MNIST(_DownloadedDataset):
    """MNIST from local idx files (reference: vision.py:MNIST)."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        paths = []
        for fname in files:
            for cand in (os.path.join(self._root, fname),
                         os.path.join(self._root, fname + ".gz")):
                if os.path.exists(cand):
                    paths.append(cand)
                    break
            else:
                raise MXNetError(
                    "MNIST file %s not found under %s (nothing is "
                    "downloaded: place the idx files there, or use "
                    "SyntheticImageDataset)" % (fname, self._root))
        data = _read_idx(paths[0])
        label = _read_idx(paths[1])
        self._data = nd.array(
            data.reshape(-1, 28, 28, 1).astype(np.float32) / 255)
        self._label = label.astype(np.int32)


class FashionMNIST(MNIST):
    """(reference: vision.py:FashionMNIST) — same idx format as MNIST."""

    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from local binary batches (reference: vision.py:CIFAR10)."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        if self._train:
            files = ["data_batch_%d.bin" % i for i in range(1, 6)]
        else:
            files = ["test_batch.bin"]
        data = []
        label = []
        for fname in files:
            path = os.path.join(self._root, fname)
            if not os.path.exists(path):
                raise MXNetError(
                    "CIFAR10 file %s not found (nothing is downloaded: "
                    "place the binary batches under %s)"
                    % (fname, self._root))
            raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3073)
            label.append(raw[:, 0])
            data.append(raw[:, 1:].reshape(-1, 3, 32, 32))
        data = np.concatenate(data).transpose(0, 2, 3, 1)
        self._data = nd.array(data.astype(np.float32) / 255)
        self._label = np.concatenate(label).astype(np.int32)


class CIFAR100(CIFAR10):
    """CIFAR100 from the local binary archive (reference:
    vision.py:222 — fine_label picks 100 classes vs 20 coarse)."""

    def __init__(self, root="~/.mxnet/datasets/cifar100", fine_label=False,
                 train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root=root, train=train, transform=transform)

    def _get_data(self):
        files = ["train.bin"] if self._train else ["test.bin"]
        data, label = [], []
        for fname in files:
            path = os.path.join(self._root, fname)
            if not os.path.exists(path):
                raise MXNetError(
                    "CIFAR100 file %s not found (nothing is downloaded: "
                    "place the binary batches under %s)"
                    % (fname, self._root))
            raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3074)
            # byte 0 = coarse label, byte 1 = fine label (reference
            # vision.py _read_batch uses column 0 + fine_label)
            label.append(raw[:, 0 + int(self._fine_label)])
            data.append(raw[:, 2:].reshape(-1, 3, 32, 32))
        data = np.concatenate(data).transpose(0, 2, 3, 1)
        self._data = nd.array(data.astype(np.float32) / 255)
        self._label = np.concatenate(label).astype(np.int32)


class ImageRecordDataset(RecordFileDataset):
    """Images + labels from a packed .rec file (reference:
    vision.py:258). Random access via the .idx sidecar."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        record = super().__getitem__(idx)
        header, img = recordio.unpack(record)
        out = image.imdecode(img, self._flag)
        if self._transform is not None:
            return self._transform(out, header.label)
        return out, header.label


class ImageFolderDataset(Dataset):
    """A dataset of images arranged root/category/image.ext
    (reference: vision.py:ImageFolderDataset). Decoding uses PIL if
    available, else raw numpy for .npy files."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".npy"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1].lower()
                if ext not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        fname, label = self.items[idx]
        if fname.endswith(".npy"):
            img = nd.array(np.load(fname))
        else:
            try:
                from PIL import Image
            except ImportError:
                raise MXNetError("decoding %s requires PIL" % fname)
            img = nd.array(np.asarray(Image.open(fname)).astype(np.float32))
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class SyntheticImageDataset(Dataset):
    """Deterministic synthetic classification images (an offline
    stand-in for tests and examples)."""

    def __init__(self, num_samples=1000, shape=(28, 28, 1), num_classes=10,
                 seed=42, transform=None):
        rng = np.random.RandomState(seed)
        templates = rng.uniform(0, 1, (num_classes,) + shape) \
            .astype(np.float32)
        labels = rng.randint(0, num_classes, num_samples)
        imgs = np.clip(templates[labels] + rng.normal(
            0, 0.3, (num_samples,) + shape).astype(np.float32), 0, 1)
        self._data = nd.array(imgs)
        self._label = labels.astype(np.int32)
        self._transform = transform

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)
