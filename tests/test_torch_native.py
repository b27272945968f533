"""The port's native bindings (boda_tpu_torch/utils/native.py) against
boda_tpu's (boda_tpu/utils/native.py): tests/test_native.py's cases, each
output bit-equal to the reference's on the same inputs. The port builds
native/boda_native.cc into build/native/ and never writes into native/."""

import io
import os

import numpy as np
import pytest

from boda_tpu.utils import native as ref_native
from boda_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMGS = os.path.join(REPO, "testdata", "images")


@pytest.fixture
def libs():
    if not native.native_available():
        pytest.skip(f"the port's native library did not build: {native.build_error}")
    if not ref_native.native_available():
        pytest.skip("boda_tpu's native library did not build")


def test_library_built_under_build_native(libs):
    so = native.lib_path()
    assert so.parent == native.BUILD_DIR and native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert so.exists() and so.name.startswith("libboda_native_")
    assert native.SRC == native._REPO / "native" / "boda_native.cc"
    # the port reads the source in native/ and writes nothing there
    assert not any(p.name.startswith("libboda_native_")
                   for p in (native._REPO / "native").iterdir())


def test_jpeg_decode_matches_reference_and_pil(libs):
    from PIL import Image
    data = open(f"{IMGS}/test2.jpg", "rb").read()
    img = native.jpeg_decode(data)
    assert np.array_equal(img, ref_native.jpeg_decode(data))
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    assert img.shape == ref.shape and np.array_equal(img, ref)


def test_jpeg_decode_error(libs):
    with pytest.raises(ValueError) as e:
        native.jpeg_decode(b"definitely not a jpeg")
    with pytest.raises(ValueError) as e_ref:
        ref_native.jpeg_decode(b"definitely not a jpeg")
    assert str(e.value) == str(e_ref.value) and "jpeg decode failed" in str(e.value)


def test_resize_and_preproc_match_reference(libs):
    from boda_tpu_torch.apps.preproc import img_to_batch_np
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (37, 53, 4), np.uint8)
    out = native.resize_bilinear(img, 21, 33)
    assert out.shape == (21, 33, 4)
    assert np.array_equal(out, ref_native.resize_bilinear(img, 21, 33))
    assert np.array_equal(out[0, 0], img[0, 0]) and np.array_equal(out[-1, -1], img[-1, -1])
    batch = rng.randint(0, 256, (2, 9, 11, 4), np.uint8)
    got = native.rgba_to_nchw_bgr(batch, scale=0.5)
    assert np.array_equal(got, ref_native.rgba_to_nchw_bgr(batch, scale=0.5))
    assert np.allclose(got, img_to_batch_np(batch, scale=0.5))


def test_f32_stats(libs):
    rng = np.random.RandomState(1)
    v = rng.randn(10000).astype(np.float32)
    got = native.f32_stats(v)
    assert got == ref_native.f32_stats(v)
    mn, mx, s, sq = got
    assert mn == pytest.approx(float(v.min())) and mx == pytest.approx(float(v.max()))
    assert s == pytest.approx(float(v.sum(dtype=np.float64)), rel=1e-9)
    assert sq == pytest.approx(float((v.astype(np.float64) ** 2).sum()), rel=1e-9)


def test_batch_loader_matches_reference(libs):
    paths = [f"{IMGS}/test2.jpg", f"{IMGS}/test2.jpg", f"{IMGS}/test2.jpg"] * 2 + \
        [f"{IMGS}/test2.jpg"]
    got, want = {}, {}
    with native.BatchLoader(paths, batch=2, y=48, x=40, n_threads=3) as L:
        buf = np.empty((2, 48, 40, 4), np.uint8)
        while True:  # into a caller's buffer, as serving fills pinned memory
            r = L.next(out=buf)
            if r is None:
                break
            bi, data = r
            assert data is buf and data.sum() > 0
            got[bi] = data.copy()
        with pytest.raises(ValueError, match="C-contiguous uint8"):
            L.next(out=np.empty((2, 48, 40, 3), np.uint8))
    with ref_native.BatchLoader(paths, batch=2, y=48, x=40, n_threads=3) as L:
        while (r := L.next()) is not None:
            want[r[0]] = r[1]
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]  # ceil(7/2) batches
    assert all(np.array_equal(got[k], want[k]) for k in got)


def test_batch_loader_error(libs):
    for bad in ("/no/such/file.jpg", f"{IMGS}/invalid.jpg"):
        with native.BatchLoader([bad], batch=1, y=8, x=8) as L:
            with pytest.raises(RuntimeError) as e:
                L.next()
        with ref_native.BatchLoader([bad], batch=1, y=8, x=8) as L:
            with pytest.raises(RuntimeError) as e_ref:
                L.next()
        assert str(e.value) == str(e_ref.value) == f"batch loader: failed to load {bad}"
