"""Recursive sorted image listing (pix2pixHD data/image_folder.py)."""

from __future__ import annotations

import os

IMG_EXTENSIONS = (
    ".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG",
    ".ppm", ".PPM", ".bmp", ".BMP", ".tiff", ".webp",
)


def is_image_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)


def make_dataset(dir_path: str, max_dataset_size=float("inf")):
    images = []
    if not os.path.isdir(dir_path):
        raise FileNotFoundError(f"{dir_path} is not a valid directory")
    for root, _, fnames in sorted(os.walk(dir_path)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    return images[: int(min(max_dataset_size, len(images)))]
