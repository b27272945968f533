"""Display/capture mode family — headless equivalents.

Counterpart of ``boda_tpu/modes/display_modes.py``, with the same outputs and
the same no-camera error. Parity targets: ref src/cap_app.cc/disp_app.cc mode family (capture_classify,
capture_feats, display_pil, display_ipc, cs_disp). This environment has no
V4L2 camera or SDL display; camera modes are feature-gated with clean errors
(as reference builds without [SDL2]/[cap] features are), and display modes
render to PNG files instead of windows.
"""

from __future__ import annotations

import numpy as np

from ..config import ConfigError, Field, Mode, register
from ..utils.img_io import Img


def _tile_images(imgs: list[Img], pad: int = 2) -> Img:
    """Simple row-major tiling of images into one canvas."""
    import math
    n = len(imgs)
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    cell_y = max(i.sz[0] for i in imgs) + pad
    cell_x = max(i.sz[1] for i in imgs) + pad
    canvas = Img.zeros(rows * cell_y + pad, cols * cell_x + pad, fill=32)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        canvas.paste(im, pad + r * cell_y, pad + c * cell_x)
    return canvas


@register("mode", "display_pil", help="render an image list to a tiled PNG")
class DisplayPil(Mode):
    img_fns = Field((list, "filename"), req=True, help="images to display")
    out_fn = Field(str, default="display.png", help="output PNG")
    max_sz = Field(int, default="256", help="per-image max dimension")

    def main(self) -> None:
        imgs = []
        for fn in self.img_fns:
            im = Img.load(fn)
            y, x = im.sz
            scale = min(1.0, self.max_sz / max(y, x))
            if scale < 1.0:
                im = im.resize(int(y * scale), int(x * scale))
            imgs.append(im)
        out = _tile_images(imgs)
        out.save(self.out_path(self.out_fn))
        print(f"display_pil: {len(imgs)} images -> {self.out_fn} "
              f"({out.sz[0]}x{out.sz[1]})")


@register("mode", "display_stream", help="render a data stream's image blocks to PNGs")
class DisplayStream(Mode):
    src = Field("data_stream", req=True, help="image-block source")
    max_frames = Field(int, default="16", help="frame limit")

    def main(self) -> None:
        from .. import stream  # noqa: F401
        self.src.start()
        n = 0
        while n < self.max_frames:
            b = self.src.read()
            if b is None:
                break
            if b.nda is None or b.nda.data.ndim != 3:
                continue
            Img(b.nda.data.astype(np.uint8)).save(
                self.out_path(f"frame_{n:04d}.png"))
            n += 1
        print(f"display_stream: wrote {n} frames")


def _no_camera(mode_name: str):
    raise ConfigError(
        f"{mode_name}: no V4L2 camera available in this environment (the "
        f"reference gates camera modes behind its [cap]/[SDL2] build features "
        f"the same way); use cnet_predict/display_pil on image files, or the "
        f"zmq_det service for live feeds")


@register("mode", "capture_classify", help="live camera classify (needs a camera)")
class CaptureClassify(Mode):
    model = Field(str, default="", help="zoo model")

    def main(self) -> None:
        _no_camera("capture_classify")


@register("mode", "capture_feats", help="live camera features (needs a camera)")
class CaptureFeats(Mode):
    model = Field(str, default="", help="zoo model")

    def main(self) -> None:
        _no_camera("capture_feats")
