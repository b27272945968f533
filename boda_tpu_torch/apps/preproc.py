"""Image -> net-input preprocessing on the host.

Counterpart of ``boda_tpu/apps/preproc.py``'s host transform: RGBA images to
a mean-subtracted BGR float batch (ref ``subtract_mean_and_copy_img_to_batch``,
caffeif.H:13), and the center crop; and the device form of the transform,
``img_to_batch_torch`` (boda_tpu's ``img_to_batch_jax``), which serving
captures in one CUDA graph with the net, so that uint8 RGBA is what crosses
the host-to-card link.
"""

from __future__ import annotations

import numpy as np

# Caffe ImageNet channel means, BGR order (ref caffeif.cc u32_rgba_inmc usage)
IMAGENET_MEAN_BGR = (104.0, 117.0, 123.0)


def img_to_batch_torch(rgba_u8, mean_bgr=IMAGENET_MEAN_BGR, scale: float = 1.0,
                       out_dtype=None, layout: str = "nchw"):
    """(img, y, x, 4) uint8 RGBA tensor -> mean-subtracted BGR batch on the
    tensor's device: ``layout='nchw'`` gives the logical (img, 3, y, x),
    ``'nhwc'`` gives (img, y, x, 3), the engine's ingestion layout, which it
    takes without a permute. The arithmetic is boda_tpu's, in f32: the u8
    value minus the f32 mean, times ``scale``, then cast to ``out_dtype``
    (default f32); exact in f32 for integer means and scale 1.

    ``mean_bgr`` may be a 3-element f32 tensor on the same device: inside a
    CUDA-graph capture a tensor cannot be made from a host list (that is a
    synchronous copy), so a captured caller makes it beforehand."""
    import torch
    out_dtype = out_dtype or torch.float32
    if rgba_u8.dim() != 4 or rgba_u8.shape[3] != 4 or rgba_u8.dtype != torch.uint8:
        raise ValueError(f"img_to_batch_torch: want (img, y, x, 4) uint8, got "
                         f"{rgba_u8.dtype} {tuple(rgba_u8.shape)}")
    if layout not in ("nchw", "nhwc"):
        raise ValueError(f"img_to_batch_torch: layout {layout!r}: want nchw or nhwc")
    if not isinstance(mean_bgr, torch.Tensor):
        mean_bgr = torch.tensor(mean_bgr, dtype=torch.float32, device=rgba_u8.device)
    bgr = torch.flip(rgba_u8[..., :3], dims=(-1,))   # RGBA -> BGR, u8 (no index tensor:
    #                                                   a capture cannot upload one)
    if layout == "nhwc":
        mean = mean_bgr.reshape(1, 1, 1, 3)
    else:
        bgr = bgr.permute(0, 3, 1, 2)                               # (img, 3, y, x)
        mean = mean_bgr.reshape(1, 3, 1, 1)
    x = torch.sub(bgr, mean)        # u8 promoted to f32 in the subtraction: exact
    if scale != 1.0:                # times 1.0 is the identity in f32
        x = x * scale
    return x.to(out_dtype).contiguous()


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
