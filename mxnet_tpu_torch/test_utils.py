"""Test helpers (counterpart of ``mxnet_tpu/test_utils.py``; only
:func:`get_mnist` is ported)."""
from __future__ import annotations

import numpy as np

__all__ = ["get_mnist"]


def get_mnist():
    """Synthetic MNIST-shaped dataset (reference: test_utils.py:get_mnist
    downloads the real one; offline here, so deterministic synthetic digits
    with a learnable class structure are generated instead). The same
    numpy draws in the same order as the JAX package's, so the arrays are
    bit-identical."""
    rng = np.random.RandomState(42)
    n_train, n_test = 6000, 1000
    templates = rng.uniform(0, 1, (10, 1, 28, 28)).astype(np.float32)

    def make(n):
        labels = rng.randint(0, 10, n)
        imgs = templates[labels] + rng.normal(0, 0.3, (n, 1, 28, 28)) \
            .astype(np.float32)
        return np.clip(imgs, 0, 1).astype(np.float32), \
            labels.astype(np.float32)

    train_data, train_label = make(n_train)
    test_data, test_label = make(n_test)
    return {"train_data": train_data, "train_label": train_label,
            "test_data": test_data, "test_label": test_label}
