"""Scale pyramids + bottom-left-fill bin packing of scales into batch planes.

A copy of ``boda_tpu/apps/pyramid.py`` (numpy). Parity target:
``pyra_pack_t`` / ``img_pyra_pack_t`` (ref src/blf_pack.{H,cc}:9,:72 and
modes pyra_pack/img_pyra_pack): generate a geometric scale pyramid of an
input size, then pack all scales into a minimal number of fixed-size
"planes" (batch images) using bottom-left-fill placement, so one net forward
evaluates every scale densely (the reference's multi-scale detection trick).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.img_io import Img


def pyra_sizes(base_sz: tuple[int, int], interval: int = 4,
               min_sz: int = 16, max_scales: int = 64) -> list[tuple[int, int]]:
    """Geometric pyramid: scale factor 2^(-i/interval), floor-rounded,
    until either dim would drop below min_sz."""
    out = []
    i = 0
    while len(out) < max_scales:
        s = 2.0 ** (-i / interval)
        y, x = int(base_sz[0] * s), int(base_sz[1] * s)
        if y < min_sz or x < min_sz:
            break
        out.append((y, x))
        i += 1
    return out


@dataclass
class Placement:
    plane: int
    y: int
    x: int
    sz: tuple[int, int]  # (y, x)


def blf_pack(sizes: list[tuple[int, int]], plane_sz: tuple[int, int],
             pad: int = 0) -> list[Placement]:
    """Bottom-left-fill packing (ref blf_pack.cc): place each (padded) box at
    the lowest-then-leftmost corner candidate where it fits; open a new plane
    when nothing fits. Sizes should be sorted descending for best packing
    (placements are returned in input order)."""
    py, px = plane_sz
    planes: list[list[tuple[int, int, int, int]]] = []  # per plane placed boxes
    corners: list[list[tuple[int, int]]] = []           # per plane candidates
    out: list[Placement] = []

    def fits(pl: int, y: int, x: int, sy: int, sx: int) -> bool:
        if y + sy > py or x + sx > px:
            return False
        for (by, bx, bey, bex) in planes[pl]:
            if not (y + sy <= by or bey <= y or x + sx <= bx or bex <= x):
                return False
        return True

    for idx, (sy0, sx0) in enumerate(sizes):
        sy, sx = sy0 + pad, sx0 + pad
        if sy > py or sx > px:
            raise ValueError(f"scale {idx} ({sy0}x{sx0} +pad {pad}) exceeds "
                             f"plane {py}x{px}")
        placed = False
        for pl in range(len(planes)):
            for (y, x) in sorted(corners[pl], key=lambda c: (c[0], c[1])):
                if fits(pl, y, x, sy, sx):
                    planes[pl].append((y, x, y + sy, x + sx))
                    corners[pl].remove((y, x))
                    corners[pl].extend([(y + sy, x), (y, x + sx)])
                    out.append(Placement(pl, y, x, (sy0, sx0)))
                    placed = True
                    break
            if placed:
                break
        if not placed:
            planes.append([(0, 0, sy, sx)])
            corners.append([(sy, 0), (0, sx)])
            out.append(Placement(len(planes) - 1, 0, 0, (sy0, sx0)))
    return out


@dataclass
class ImgPyraPack:
    planes: np.ndarray                 # (n_planes, py, px, 4) uint8
    placements: list[Placement]
    sizes: list[tuple[int, int]]


def img_pyra_pack(img: Img, plane_sz: tuple[int, int], interval: int = 4,
                  min_sz: int = 16, pad: int = 0) -> ImgPyraPack:
    """Scale the image to every pyramid size and pack into planes
    (ref img_pyra_pack_t, blf_pack.H:72)."""
    base = img.sz
    sizes = pyra_sizes(base, interval=interval, min_sz=min_sz)
    # clamp scale 0 to the plane if the input is larger than a plane
    sizes = [(min(y, plane_sz[0] - pad), min(x, plane_sz[1] - pad))
             for (y, x) in sizes]
    placements = blf_pack(sizes, plane_sz, pad=pad)
    n_planes = max(p.plane for p in placements) + 1
    planes = np.zeros((n_planes, plane_sz[0], plane_sz[1], 4), np.uint8)
    planes[..., 3] = 255
    for pl, sz in zip(placements, sizes):
        scaled = img.resize(*sz)
        planes[pl.plane, pl.y:pl.y + sz[0], pl.x:pl.x + sz[1]] = scaled.data
    return ImgPyraPack(planes, placements, sizes)


def feat_coords_of_placement(p: Placement, support_stride: tuple[int, int],
                             eff_tot_pad: tuple[int, int]) -> tuple[int, int, int, int]:
    """Map an image-plane placement to feature-map coordinates via the
    receptive-field calculus (ref conv_common.H:33-40 box mappings):
    feature index f covers input span starting at f*stride - pad."""
    sy, sx = support_stride
    fy0 = (p.y + eff_tot_pad[0]) // sy if sy else 0
    fx0 = (p.x + eff_tot_pad[1]) // sx if sx else 0
    fy1 = (p.y + p.sz[0] + eff_tot_pad[0]) // sy if sy else 0
    fx1 = (p.x + p.sz[1] + eff_tot_pad[1]) // sx if sx else 0
    return fy0, fx0, fy1, fx1
