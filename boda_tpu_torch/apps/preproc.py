"""Image -> net-input preprocessing on the host.

Counterpart of ``boda_tpu/apps/preproc.py``'s host transform: RGBA images to
a mean-subtracted BGR float batch (ref ``subtract_mean_and_copy_img_to_batch``,
caffeif.H:13), and the center crop. boda_tpu's jax form of the transform,
which runs inside its jit, is not ported.
"""

from __future__ import annotations

import numpy as np

# Caffe ImageNet channel means, BGR order (ref caffeif.cc u32_rgba_inmc usage)
IMAGENET_MEAN_BGR = (104.0, 117.0, 123.0)


def img_to_batch_np(rgba_u8: np.ndarray, mean_bgr=IMAGENET_MEAN_BGR,
                    scale: float = 1.0) -> np.ndarray:
    """(img, y, x, 4) uint8 RGBA -> (img, 3, y, x) mean-subtracted BGR f32."""
    x = rgba_u8.astype(np.float32)
    bgr = np.stack([x[..., 2], x[..., 1], x[..., 0]], axis=1)
    mean = np.asarray(mean_bgr, np.float32).reshape(1, 3, 1, 1)
    return (bgr - mean) * scale


def center_crop(img_data: np.ndarray, y: int, x: int) -> np.ndarray:
    """Center-crop (y0,x0) so output is (y, x, C)."""
    iy, ix = img_data.shape[:2]
    if iy < y or ix < x:
        raise ValueError(f"crop {y}x{x} larger than image {iy}x{ix}")
    y0 = (iy - y) // 2
    x0 = (ix - x) // 2
    return img_data[y0:y0 + y, x0:x0 + x]
