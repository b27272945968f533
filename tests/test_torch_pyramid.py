"""The port's copy of the scale pyramid and its packing
(boda_tpu_torch/apps/pyramid.py): tests/test_apps.py's pyramid cases on the
port, each result also equal to boda_tpu's (boda_tpu/apps/pyramid.py)."""

import dataclasses
import os

import numpy as np
import pytest

from boda_tpu.apps import pyramid as ref
from boda_tpu.utils.img_io import Img as RefImg
from boda_tpu_torch.apps.pyramid import (blf_pack, feat_coords_of_placement, img_pyra_pack,
                                         pyra_sizes)
from boda_tpu_torch.utils.img_io import Img

IMGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "testdata", "images")


def test_pyra_sizes():
    sz = pyra_sizes((256, 256), interval=2, min_sz=32)
    assert sz == ref.pyra_sizes((256, 256), interval=2, min_sz=32)
    assert sz[0] == (256, 256)
    assert sz[1] == (181, 181)  # 2^-0.5
    assert all(s[0] >= 32 for s in sz)
    assert all(a[0] > b[0] for a, b in zip(sz, sz[1:]))  # strictly decreasing
    assert pyra_sizes((480, 320), 4, 16) == ref.pyra_sizes((480, 320), 4, 16)


def test_blf_pack_fits_and_no_overlap():
    sizes = [(100, 200), (100, 100), (50, 50), (50, 50), (25, 25)]
    pl = blf_pack(sizes, (128, 256))
    assert [dataclasses.astuple(p) for p in pl] == \
        [dataclasses.astuple(p) for p in ref.blf_pack(sizes, (128, 256))]
    assert len(pl) == len(sizes)
    by_plane = {}
    for p in pl:
        by_plane.setdefault(p.plane, []).append(p)
    for plist in by_plane.values():
        for i, a in enumerate(plist):
            for b in plist[i + 1:]:
                no = (a.y + a.sz[0] <= b.y or b.y + b.sz[0] <= a.y or
                      a.x + a.sz[1] <= b.x or b.x + b.sz[1] <= a.x)
                assert no, f"overlap {a} {b}"
    with pytest.raises(ValueError, match="exceeds"):
        blf_pack([(300, 300)], (128, 256))
    padded = blf_pack(sizes, (256, 256), pad=3)
    assert [dataclasses.astuple(p) for p in padded] == \
        [dataclasses.astuple(p) for p in ref.blf_pack(sizes, (256, 256), pad=3)]


def test_img_pyra_pack_and_feat_coords():
    im = Img.load(f"{IMGS}/test1.png")
    pack = img_pyra_pack(im, (256, 256), interval=2, min_sz=64)
    want = ref.img_pyra_pack(RefImg.load(f"{IMGS}/test1.png"), (256, 256), interval=2,
                             min_sz=64)
    assert pack.planes.dtype == np.uint8
    assert pack.planes.shape[1:] == (256, 256, 4)
    assert len(pack.placements) == len(pack.sizes) >= 3
    assert np.array_equal(pack.planes, want.planes) and pack.sizes == want.sizes
    for p, q in zip(pack.placements, want.placements):
        assert dataclasses.astuple(p) == dataclasses.astuple(q)
        for stride, pad in (((1, 1), (1, 1)), ((4, 4), (0, 0)), ((16, 8), (5, 3))):
            assert feat_coords_of_placement(p, stride, pad) == \
                ref.feat_coords_of_placement(q, stride, pad)
