"""Raw KITTI object-detection file I/O (host side, numpy).

Port of ``epnet_tpu/data/kitti_dataset.py`` (reference
``lib/datasets/kitti_dataset.py``): velodyne ``.bin`` as (N, 4) float32
(:69-72), images RGB, normalized with the ImageNet statistics and
zero-padded to 384x1280 (:37-57), calib and label parsers (:74-97), and
the road planes of the gt-paste augmentation (``get_road_plane``). Images
are read by the port's ``data/png.py``, not PIL. ``img_cache`` (a
directory; JAX's ``EPNET_IMG_CACHE``, ``kitti_dataset.py:44-79``) caches
each decoded image's uint8 pixels as ``%06d.npy`` at its first read, in
the JAX package's format, so one cache serves both packages.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import png
from .calibration import Calibration
from .object3d import load_label_file

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
PAD_H, PAD_W = 384, 1280


class KittiDataset:
    def __init__(self, root_dir: str, split: str = 'train', img_cache: Optional[str] = None):
        is_test = split == 'test'
        self.imageset_dir = os.path.join(root_dir, 'KITTI', 'object',
                                         'testing' if is_test else 'training')
        split_file = os.path.join(root_dir, 'KITTI', 'ImageSets', split + '.txt')
        with open(split_file) as f:
            self.image_idx_list = [x.strip() for x in f.readlines() if x.strip()]

        self.image_dir = os.path.join(self.imageset_dir, 'image_2')
        self.lidar_dir = os.path.join(self.imageset_dir, 'velodyne')
        self.calib_dir = os.path.join(self.imageset_dir, 'calib')
        self.label_dir = os.path.join(self.imageset_dir, 'label_2')
        self.plane_dir = os.path.join(self.imageset_dir, 'planes')
        self.img_cache = img_cache

    def get_lidar(self, idx: int) -> np.ndarray:
        path = os.path.join(self.lidar_dir, '%06d.bin' % idx)
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)

    def get_image_rgb_with_normal(self, idx: int) -> np.ndarray:
        """(384, 1280, 3) float32, ImageNet-normalized, zero-padded (an image
        larger than that is cropped). The pixels come from ``img_cache``
        when it holds them; else they are decoded and, with a cache, saved
        there (a name carrying the pid, then ``os.replace``, so workers
        sharing the cache never leave a torn file)."""
        raw = None
        if self.img_cache:
            cpath = os.path.join(self.img_cache, '%06d.npy' % idx)
            if os.path.exists(cpath):
                raw = np.load(cpath)
        if raw is None:
            raw = png.read_rgb(os.path.join(self.image_dir, '%06d.png' % idx))
            if self.img_cache:
                os.makedirs(self.img_cache, exist_ok=True)
                tmp = cpath + '.tmp.%d' % os.getpid()
                with open(tmp, 'wb') as f:  # a handle: np.save would append .npy
                    np.save(f, raw)
                os.replace(tmp, cpath)
        im = raw.astype(np.float32) / 255.0
        im = (im - IMAGENET_MEAN) / IMAGENET_STD
        out = np.zeros((PAD_H, PAD_W, 3), np.float32)
        out[:im.shape[0], :im.shape[1]] = im[:PAD_H, :PAD_W]
        return out

    def get_image_shape(self, idx: int):
        h, w, _ = png.read_header(os.path.join(self.image_dir, '%06d.png' % idx))
        return h, w, 3

    def get_calib(self, idx: int) -> Calibration:
        return Calibration(os.path.join(self.calib_dir, '%06d.txt' % idx))

    def get_label(self, idx: int):
        return load_label_file(os.path.join(self.label_dir, '%06d.txt' % idx))

    def get_road_plane(self, idx: int) -> np.ndarray:
        """The plane ``(a, b, c, d)`` of frame ``idx``'s road, its normal
        pointing up (``b < 0`` in rect coordinates) and of unit length."""
        with open(os.path.join(self.plane_dir, '%06d.txt' % idx)) as f:
            lines = f.readlines()
        plane = np.asarray([float(v) for v in lines[3].split()])
        if plane[1] > 0:
            plane = -plane
        return plane / np.linalg.norm(plane[0:3])
