"""Image type, codec IO and resampling.

Counterpart of ``boda_tpu/utils/img_io.py``: an image is a numpy (y, x, 4)
uint8 RGBA array; PIL is the png/jpeg codec and the LANCZOS resampler. PIL
is optional and imported only where a codec or a resample is needed:
without it ``load``, ``save`` and a ``resize`` that changes the size raise
:class:`ImgError` naming PIL. A ``resize`` to the image's own size is a copy
(what PIL's ``Image.resize`` returns for an unchanged size), so records at a
net's input size never need PIL.
"""

from __future__ import annotations

import os

import numpy as np


class ImgError(ValueError):
    pass


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImgError(f"image codecs and resampling need PIL, which is not "
                       f"installed ({e})") from None
    return Image


class Img:
    """RGBA uint8 image: data shape (y, x, 4)."""

    __slots__ = ("data",)

    def __init__(self, data: np.ndarray):
        data = np.asarray(data)
        if data.ndim != 3 or data.shape[2] != 4 or data.dtype != np.uint8:
            raise ImgError(f"Img: want (y,x,4) uint8, got {data.shape} {data.dtype}")
        self.data = data

    @property
    def sz(self) -> tuple[int, int]:  # (y, x)
        return self.data.shape[0], self.data.shape[1]

    @staticmethod
    def zeros(y: int, x: int, fill: int = 0) -> "Img":
        d = np.full((y, x, 4), fill, dtype=np.uint8)
        d[:, :, 3] = 255
        return Img(d)

    @staticmethod
    def from_rgb(rgb: np.ndarray) -> "Img":
        rgb = np.asarray(rgb, dtype=np.uint8)
        a = np.full(rgb.shape[:2] + (1,), 255, np.uint8)
        return Img(np.concatenate([rgb, a], axis=2))

    def rgb(self) -> np.ndarray:
        return self.data[:, :, :3]

    # -- codec io ---------------------------------------------------------------
    @staticmethod
    def load(fn: str) -> "Img":
        if not os.path.exists(fn):
            raise ImgError(f"image file not found: {fn!r}")
        Image = _pil_image()
        try:
            with Image.open(fn) as im:
                return Img(np.asarray(im.convert("RGBA")))
        except Exception as e:
            raise ImgError(f"failed to load image {fn!r}: {e}") from None

    @staticmethod
    def from_bytes(data: bytes, what: str = "image") -> "Img":
        """Decode an in-memory encoded image (an MJPEG AVI chunk, say)."""
        import io
        Image = _pil_image()
        try:
            with Image.open(io.BytesIO(data)) as im:
                return Img(np.asarray(im.convert("RGBA")))
        except Exception as e:
            raise ImgError(f"failed to decode {what}: {e}") from None

    def save(self, fn: str) -> None:
        _pil_image().fromarray(self.data, "RGBA").save(fn)

    # -- resampling ----------------------------------------------------------------
    def resize(self, y: int, x: int) -> "Img":
        """High-quality resample (LANCZOS); the image's own size is a copy."""
        if (y, x) == self.sz:
            return Img(self.data.copy())
        Image = _pil_image()
        im = Image.fromarray(self.data, "RGBA").resize((x, y), Image.LANCZOS)
        return Img(np.asarray(im))

    def upsample_2x(self) -> "Img":
        y, x = self.sz
        return self.resize(y * 2, x * 2)

    def crop(self, y0: int, x0: int, y1: int, x1: int) -> "Img":
        return Img(np.ascontiguousarray(self.data[y0:y1, x0:x1]))

    def paste(self, other: "Img", y: int, x: int) -> None:
        oy, ox = other.sz
        self.data[y:y + oy, x:x + ox] = other.data
