"""K8 (csrc/pool.cu) on each of its routes and K9 (csrc/eltwise.cu) on each of
its paths, against their plain versions on the card, each case asserting the
route or path it took (``pool2d.paths``, ``eltwise.paths``). Plans other than
the wrappers' own (other rings and grids) are launched through the kernels'
C entry points, on outputs filled with NaN beforehand: an output that no
block wrote fails, so these cases hold the kernels' split of a plan's work.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. Run them on
the machine with the card from the repo root with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_pool.py``.
Tolerances: max pools exact (a max is one of its inputs); avg pools within
1e-2 of max|ref| in bf16 (one rounding of an f32 sum taken in another
order) and 1e-5 in f32; K9 bit for bit, NaN, +-0 and +-inf included (both
compute each element in f32 and round once).
"""

import numpy as np
import pytest
import torch

from boda_tpu_torch.ops.kernels import build
from boda_tpu_torch.ops.kernels import elementwise as elt
from boda_tpu_torch.ops.kernels.pool import ROUTES, PoolPlan, pool2d, pool2d_plain, rows_plan

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
TOL = {torch.float32: 1e-5, BF16: 1e-2}
ELT_B32 = 32 * 256 * 56 * 56


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    return torch.device("cuda")


def _x(shape, dev, dt, seed=0, misaligned=False):
    v = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(v).to(dev, dt)
    if not misaligned:
        return t
    buf = torch.empty(t.numel() + 1, dtype=dt, device=dev)
    out = buf[1:].view(shape)  # 2 or 4 bytes off 16-byte alignment
    out.copy_(t)
    return out


def _geom(x, k, s, oy, avg):
    h = x.shape[1]
    pad = (0, max(0, (oy - 1) * s + k - h))
    return ((k, k), (s, s), pad, pad, oy, oy, avg)


def _pool(x, k, s, oy, avg):
    """One K8 launch through pool2d on caffe's ceil-mode geometry: (output,
    plain version, the route it ran)."""
    args = _geom(x, k, s, oy, avg)
    paths = dict(pool2d.paths)
    out = pool2d(x, *args)
    torch.cuda.synchronize()
    ran = [r for r in paths if pool2d.paths[r] == paths[r] + 1]
    return out, pool2d_plain(x, *args), ran


def _pool_plan(x, k, s, oy, avg, p):
    """One K8 launch of plan ``p`` through boda_pool2d, into an output of
    NaN: (output, plain version)."""
    n, h, w, c = x.shape
    args = _geom(x, k, s, oy, avg)
    out = torch.full((n, oy, oy, c), float("nan"), dtype=x.dtype, device=x.device)
    params = (p.blocks, p.slots) if p.route == "rows" else (p.lanes, p.slices)
    rc = build.load().lib.boda_pool2d(x.data_ptr(), out.data_ptr(), n, h, w, c, oy, oy, k, k,
                                      s, s, 0, 0, int(avg), 1, ROUTES.index(p.route),
                                      *params, build.stream_ptr(x))
    build.check(rc, f"boda_pool2d {p}")
    torch.cuda.synchronize()
    return out, pool2d_plain(x, *args)


def _check(out, ref, avg, dt, what):
    assert out.shape == ref.shape and bool(torch.isfinite(out.float()).all()), what
    if not avg:
        assert torch.equal(out, ref), what
    else:
        err = float((out.float() - ref.float()).abs().max()) / float(ref.float().abs().max())
        assert err <= TOL[dt], (what, err)


def test_pool_b32_fused_shapes(dev):
    # pool1 (3x3 s2 max, its last window clipped) on rows, pool5 (7x7 avg) on window
    for (n, h, c, k, s, oy, avg), want in (((32, 112, 64, 3, 2, 56, False), "rows"),
                                           ((32, 7, 2048, 7, 1, 1, True), "window")):
        out, ref, ran = _pool(_x((n, h, h, c), dev, BF16), k, s, oy, avg)
        assert ran == [want] and pool2d.last_plan.route == want
        _check(out, ref, avg, BF16, (h, c, want))


@pytest.mark.parametrize("dt", [BF16, torch.float32], ids=["bf16", "f32"])
def test_pool_ragged_routes(dev, dt):
    # (n, h, c, k, s, oy, avg, misaligned) -> the bf16 route; f32 is always thread
    cases = [((2, 14, 16, 3, 2, 7, False, False), "rows"),
             ((2, 14, 16, 3, 2, 7, True, False), "rows"),
             ((3, 12, 16, 2, 2, 6, True, False), "rows"),
             ((2, 31, 8, 3, 2, 15, False, False), "rows"),
             ((2, 7, 24, 7, 1, 1, True, False), "window"),
             ((2, 7, 256, 7, 1, 1, False, False), "window"),
             ((3, 9, 64, 7, 2, 2, True, False), "window"),
             ((2, 13, 12, 3, 2, 6, False, False), "thread"),
             ((2, 14, 16, 3, 2, 7, False, True), "thread"),
             ((2, 9, 16, 3, 1, 7, True, False), "thread")]
    for i, ((n, h, c, k, s, oy, avg, mis), want) in enumerate(cases):
        x = _x((n, h, h, c), dev, dt, seed=i, misaligned=mis)
        out, ref, ran = _pool(x, k, s, oy, avg)
        assert ran == [want if dt == BF16 else "thread"], (i, ran)
        _check(out, ref, avg, dt, (i, ran))


def test_pool_every_ring_grid_and_split(dev):
    # rows: pool1's class at b2 and an odd plane, max and avg, on rings of 1 to 8
    # input rows and grids of 1 block (every output row through one ring), a few
    # blocks (shares that cross images) and one block per output row
    for n, h, c, oy in ((2, 112, 64, 56), (3, 31, 8, 15)):
        for avg in (False, True):
            x = _x((n, h, h, c), dev, BF16, seed=oy)
            for slots in (1, 2, 5, 8):
                for sms in (1, 5, n * oy):
                    p = rows_plan(n, h, c, (3, 3), oy, oy, avg, slots, sms)
                    out, ref = _pool_plan(x, 3, 2, oy, avg, p)
                    _check(out, ref, avg, BF16, (h, slots, p.blocks, avg))
    # window: pool5's class and a clipped 7x7 s2, max and avg, the window's
    # pixels split into 1 to 49 slices and the channels into lanes of 1 to 32
    for n, h, c, s, oy in ((2, 7, 2048, 1, 1), (3, 9, 64, 2, 2)):
        for avg in (False, True):
            x = _x((n, h, h, c), dev, BF16, seed=h)
            for lanes, slices in ((32, 8), (32, 1), (16, 16), (8, 32), (1, 49), (5, 7)):
                p = PoolPlan("window", 0, 0, lanes, slices, 0)
                out, ref = _pool_plan(x, 7, s, oy, avg, p)
                _check(out, ref, avg, BF16, (h, lanes, slices, avg))


def _elt_inputs(n, dt, dev, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n + 1).astype(np.float32)
    b = rng.standard_normal(n + 1).astype(np.float32)
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, -1.5, 0.0, -0.0], np.float32)
    m = min(8, n + 1)
    a[:m], b[:m] = special[:m], special[::-1][:m]
    a[-m:], b[-m:] = special[:m], special[:m]  # the tail too; ties at the end
    return torch.from_numpy(a).to(dev, dt), torch.from_numpy(b).to(dev, dt)


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _elt_plan(func, ins, p):
    """One K9 launch of plan ``p`` through boda_eltwise, into an output of
    NaN (0xff bytes, a NaN neither path writes)."""
    x = ins[0]
    out = torch.empty_like(x)
    out.view(torch.uint8).fill_(255)
    rc = build.load().lib.boda_eltwise(x.data_ptr(), ins[-1].data_ptr() if len(ins) == 2
                                       else None, out.data_ptr(), x.numel(),
                                       elt.FUNC_CODES[func], elt.ELT_DTYPES[x.dtype],
                                       elt.PATHS.index(p.path), p.blocks, p.stage_bytes,
                                       p.stages, build.stream_ptr(x))
    build.check(rc, f"boda_eltwise {p}")
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("dt", [BF16, torch.float32], ids=["bf16", "f32"])
def test_eltwise_ring_and_scalar_bit_equal(dev, dt):
    stage = elt.RING_STAGE_BYTES // dt.itemsize
    for n in (1, 15, 16, stage - 1, stage + 1, 100_003, ELT_B32):
        a0, b0 = _elt_inputs(n, dt, dev, n % 97)
        vec = 16 // dt.itemsize
        for func in elt.FUNC_CODES:
            binary = func in ("mul", "add", "sub", "max")
            # eltwise on the aligned array and on a view off alignment, each
            # with the path it must take
            for x, y, want in ((a0[:n], b0[:n], "ring" if n >= vec else "scalar"),
                               (a0[1:], b0[1:], "scalar")):
                ins = (x, y) if binary else (x,)
                before = dict(elt.eltwise.paths)
                out = elt.eltwise(func, *ins)
                torch.cuda.synchronize()
                ran = [p for p in before if elt.eltwise.paths[p] == before[p] + 1]
                assert ran == [want], (n, func, ran)
                ref = elt.eltwise_plain(func, *ins)
                assert torch.equal(_bits(out), _bits(ref)), (n, func, want)
            # the scalar path on the aligned array, and the ring with a grid
            # of one block and of a few
            ins = (a0[:n], b0[:n]) if binary else (a0[:n],)
            ref = elt.eltwise_plain(func, *ins)
            ring = elt.plan(n, dt, True)
            plans = [elt.plan(n, dt, False)] + ([ring._replace(blocks=b) for b in (1, 7)]
                                                if ring.path == "ring" else [])
            for p in plans:
                out = _elt_plan(func, ins, p)
                assert torch.equal(_bits(out), _bits(ref)), (n, func, p)


def test_eltwise_ring_plan_on_misaligned_input_raises(dev):
    a = torch.ones(1001, dtype=BF16, device=dev)
    with pytest.raises(RuntimeError):
        _elt_plan("add", (a[1:], a[1:]), elt.plan(1000, BF16, True))
    # one block walking the whole b32 array through its ring
    x, y = _elt_inputs(ELT_B32, BF16, dev, 3)
    p = elt.plan(ELT_B32, BF16, True)._replace(blocks=1)
    out = _elt_plan("add", (x[:ELT_B32], y[:ELT_B32]), p)
    assert torch.equal(_bits(out), _bits(elt.eltwise_plain("add", x[:ELT_B32], y[:ELT_B32])))
