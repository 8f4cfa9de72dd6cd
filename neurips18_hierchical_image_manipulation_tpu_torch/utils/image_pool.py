"""Fake-image replay buffer (pix2pixHD util/image_pool.py) — a verbatim
copy of ``utils/image_pool.py`` in the JAX package (``:16-39``): the same
``RandomState(seed)`` draws, so one seed replays the same sequence.

Host-side: the discriminator's step takes a mix of fresh and replayed
fakes (50/50 once the pool is full); ``pool_size=0`` is passthrough.
"""

from __future__ import annotations

import numpy as np


class ImagePool:
    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.images = []
        self.rng = np.random.RandomState(seed)

    def query(self, images):
        """images: (B,H,W,C) host array of fakes. Returns same-shape array
        mixing fresh fakes with replayed ones (50/50 once full)."""
        if self.pool_size == 0:
            return images
        images = np.asarray(images)
        out = []
        for image in images:
            if len(self.images) < self.pool_size:
                self.images.append(image.copy())
                out.append(image)
            elif self.rng.uniform() > 0.5:
                idx = self.rng.randint(0, self.pool_size)
                out.append(self.images[idx].copy())
                self.images[idx] = image.copy()
            else:
                out.append(image)
        return np.stack(out)
