"""The GEMM core's edge route (``wgmma_edge``: N % 8 != 0 and even) on the CPU.

* ``plan_gemm`` (ops/kernels/common.py) gives it at ssd300's six mbox_conf
  heads at b4 and at fc1000's (tp=2) slice (M = 32, K = 2,048, N = 500), with
  tiles of 64 or 128 rows and columns that cover the problem, an even K split
  (the small-M, deep-K heads split), a persistent grid no larger than the
  SMs; the mma.sync loop keeps odd N, the GEMM's K % 8 != 0 on a dense A
  (fc1000's (tp=2) dgrad on a dense dY), a narrow conv with N % 8 != 0 and a
  misaligned operand.
* fc1000's (tp=2) backward on dY's rows padded to 16 bytes (GenFc writes dY
  so, ``copy_rows``): its dgrad (A with K = 500 at lda 504) plans the wgmma
  ring, its wgrad (B with N = 500 at ldb 504) K5's wgmma_edge, as
  chip_smoke.py's ``call_path`` states the rule for the step's calls; on the
  CPU GenFc's backward through the plain versions is bit-equal to the
  products on the unpadded dY, and hands both kernels dY at a row stride of
  504.
* The HWIO prep (graph/lowering_nhwc.py) holds the logical (KH, KW, C, OC)
  view of filters whose rows are padded to a multiple of 8 with zeros
  (``pad_rows``), which ``check_rows`` reads back; its inverse gives the
  logical filters, and a gradient through it equals the dense one.
* The port's NHWC conv rule at OC = 84 and 126 (the 3x3 direct conv, a
  strided one, and a 1x1 on K1) against boda_tpu's ``pallas`` engine
  (Pallas in interpret mode, as boda_tpu's tests run it) on the same seeded
  numpy input, every node in f32 within comp_vars(1e-5, atol 1e-5 of
  max|ref|), the port's engine holding the padded views.

The kernels themselves run on the card: tests/test_torch_cuda_gemm.py."""

import numpy as np
import pytest
import torch

import chip_smoke
from boda_tpu.config import make as jmake
from boda_tpu.graph.pipe import ConvOp as JConvOp
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.graph.lowering_nhwc import HWIO
from boda_tpu_torch.graph.pipe import ConvOp as TConvOp
from boda_tpu_torch.models.zoo import NetBuilder as TNetBuilder
from boda_tpu_torch.ops.kernels import train_conv
from boda_tpu_torch.ops.kernels.bconv import matmul_atb_plain, plan_atb
from boda_tpu_torch.ops.kernels.common import (SMEM_LIMIT, WGMMA_CHUNK, cdiv, check_rows,
                                               copy_rows, pad_rows, plan_gemm, wgmma_smem)
from boda_tpu_torch.ops.kernels.conv import conv2d_plain
from boda_tpu_torch.ops.kernels.sgemm import matmul_plain
from boda_tpu_torch.ops.kernels.train_conv import gen_conv, gen_fc
from boda_tpu_torch.utils.carry import weights_from_numpy
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims

SMS = 132  # an H100 SXM
BF16 = torch.bfloat16


def _gemm_dims(sig):
    """(M, N, K, conv C) of a conv signature (n, h, c, oc, k, s, p)."""
    n, h, c, oc, k, s, p = sig
    oh = (h + 2 * p - k) // s + 1
    return n * oh * oh, oc, k * k * c, c


# the six heads, fc1000's (tp=2) slice, and other even N % 8 != 0
_EDGE = [_gemm_dims(sig) for sig in chip_smoke.EDGE_SHAPES] + \
    [(M, N, K, None) for (kname, (M, K, N)) in chip_smoke.EDGE_GEMMS
     if kname == "sgemm" and K % 8 == 0] + \
    [(1000, 84, 64, None), (77, 20, 64, None), (6272, 126, 576, 64), (98, 500, 32, 32)]


@pytest.mark.parametrize("M,N,K,c", _EDGE)
def test_edge_plans_cover_the_problem_and_fit(M, N, K, c):
    plan = plan_gemm(M, N, K, SMS, BF16, conv_c=c)
    assert plan.path == "wgmma_edge", plan
    assert plan.bm in (64, 128) and plan.bn in (64, 128), plan
    assert plan.bn <= max(64, cdiv(N, 64) * 64), plan
    tiles = cdiv(M, plan.bm) * cdiv(N, plan.bn)
    assert tiles * plan.bm * plan.bn >= M * N
    chunks = cdiv(K, WGMMA_CHUNK)
    assert chunks % plan.split == 0 and plan.split <= min(16, chunks), plan
    assert plan.ctas == min(tiles * plan.split, SMS) <= SMS
    assert wgmma_smem(plan.bm, plan.bn) <= SMEM_LIMIT
    # a work item for at least 2/3 of the SMs, or K split as far as it goes
    assert plan.ctas >= 2 * SMS / 3 or plan.split == max(
        d for d in range(1, min(16, chunks) + 1) if chunks % d == 0), plan
    # the same product with N % 8 == 0 takes the aligned ring
    assert plan_gemm(M, cdiv(N, 8) * 8, K, SMS, BF16, conv_c=c).path == "wgmma"


def test_the_heads_and_the_fc_slice():
    heads = [plan_gemm(*_gemm_dims(sig)[:3], SMS, BF16, conv_c=sig[2])
             for sig in chip_smoke.EDGE_SHAPES]
    assert [p.path for p in heads] == ["wgmma_edge"] * 6 == \
        [chip_smoke.core_path(sig[2], sig[3]) for sig in chip_smoke.EDGE_SHAPES]
    # conv7_2 .. conv9_2: M <= 100 rows over K = 2,304, one tile: K splits
    for sig, plan in zip(chip_smoke.EDGE_SHAPES, heads):
        if _gemm_dims(sig)[0] <= 100:
            assert plan.split > 1 and plan.bm == 64, (sig, plan)
    # fc7's 126 columns: one 128-column tile, not two of 64
    fc7 = heads[list(chip_smoke.EDGE_SHAPES).index((4, 19, 1024, 126, 3, 1, 1))]
    assert fc7.bn == 128, fc7
    fc = plan_gemm(32, 500, 2048, SMS, BF16)
    assert fc.path == "wgmma_edge" and fc.split > 1 and fc.ctas <= SMS, fc
    assert chip_smoke.core_path(2048, 500, conv=False) == "wgmma_edge"


@pytest.mark.parametrize("M,N,K,c,aligned,why", [
    (5776, 83, 4608, 512, True, "odd N"),
    (1000, 21, 64, None, True, "odd N"),
    (32, 2048, 500, None, True, "fc1000's (tp=2) dgrad on a dense dY: the GEMM's K % 8"),
    (100, 84, 147, None, True, "the GEMM's K % 8 with N % 8"),
    (1000, 84, 27, 3, True, "a narrow conv with N % 8"),
    (5776, 84, 4608, 512, False, "a misaligned operand"),
    (32, 500, 2048, None, False, "a misaligned operand")])
def test_the_mma_loop_keeps_the_rest(M, N, K, c, aligned, why):
    plan = plan_gemm(M, N, K, SMS, BF16, conv_c=c, aligned=aligned)
    assert plan.path == "mma" and (plan.bm, plan.bn, plan.split) == (128, 128, 1), why
    assert plan.ctas == cdiv(M, 128) * cdiv(N, 128) <= SMS, why
    assert chip_smoke.core_path(K if c is None else c, N, conv=c is not None) == "mma" \
        or not aligned, why


@pytest.mark.parametrize("key", list(chip_smoke.EDGE_GEMMS))
def test_fc_slice_products_on_padded_rows(key):
    # each of the (tp=2) step's fc1000 products as the step lays them out:
    # the forward's B (the HWIO prep's rows) and dY (GenFc's rows) padded to
    # 504; the plans the wrappers make, as chip_smoke.py's rule states them
    kname, sig = key
    what = {"sgemm": "fc dgrad W^T" if sig[1] % 8 else "fc fwd", "atb": "fc wgrad"}[kname]
    if kname == "sgemm":
        M, K, N = sig
        plan = plan_gemm(M, N, K, SMS, BF16, lda=cdiv(K, 8) * 8)
        want = "wgmma_edge" if N % 8 else "wgmma"
        dense = plan_gemm(M, N, K, SMS, BF16)
    else:
        K, M, N = sig
        plan = plan_atb(M, N, K, 1, SMS, BF16, True, False, cdiv(N, 8) * 8)
        want = "wgmma_edge"
        dense = plan_atb(M, N, K, 1, SMS, BF16)
    assert plan.path == want == chip_smoke.call_path(kname, sig, what), plan
    assert 2 * SMS / 3 <= plan.ctas <= SMS and plan.bm in (64, 128) and plan.bn <= 128, plan
    # the dgrad and the wgrad on a dense dY: the loop, as before
    assert (dense.path == "mma") == (what != "fc fwd"), dense


@pytest.mark.parametrize("dt", [torch.float32, BF16])
def test_fc_backward_reads_dy_from_padded_rows(dt, monkeypatch):
    # GenFc's backward on the CPU (the plain versions): dY written once into
    # rows of 504, handed to the dgrad as A and to the wgrad as B; the
    # gradients bit-equal to the products on the unpadded dY
    rng = np.random.default_rng(28)
    x0, w0, b0, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
                     for s in ((32, 64), (64, 500), (500,), (32, 500)))
    seen = []

    def spy(fn):
        def call(a, b, *args, **kw):
            seen.append((fn.__name__, a.stride(), b.stride(), a.clone(), b.clone()))
            return fn(a, b, *args, **kw)
        call.__name__ = fn.__name__
        return call
    monkeypatch.setattr(train_conv, "matmul", spy(train_conv.matmul))
    monkeypatch.setattr(train_conv, "matmul_atb", spy(train_conv.matmul_atb))
    x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
    out = gen_fc(x, w, b)
    assert torch.equal(out, matmul_plain(x0, w0, b0))
    seen.clear()
    out.backward(g)
    (dn, da, _, dya, _), (wn, wa, wb, _, dyb) = seen
    assert (dn, wn) == ("matmul", "matmul_atb")
    assert da == (504, 1) and wb == (504, 1) and wa == (64, 1)
    assert torch.equal(dya, g) and torch.equal(dyb, g)
    assert torch.equal(x.grad, matmul_plain(g, w0.t().contiguous()))
    assert torch.equal(w.grad, matmul_atb_plain(x0, g).to(dt))
    assert torch.equal(b.grad, g.float().sum(0).to(dt))
    pad = copy_rows(g, dt)
    assert pad.stride() == (504, 1) and torch.equal(pad, g)
    assert copy_rows(g[:, :496], dt).is_contiguous()


@pytest.mark.parametrize("oc", [84, 126, 20, 500, 64])
@pytest.mark.parametrize("dt", [torch.float32, BF16])
def test_hwio_prep_pads_the_rows(oc, dt):
    rng = np.random.default_rng(oc)
    w = torch.from_numpy(rng.standard_normal((oc, 24, 3, 3)).astype(np.float32)).to(dt)
    h = HWIO.prep(w)
    assert h.shape == (3, 3, 24, oc) and h.dtype == dt
    assert torch.equal(h, w.permute(2, 3, 1, 0))
    ldb = check_rows("w", h, h.device, dt, (3, 3, 24, oc))
    assert ldb == cdiv(oc, 8) * 8 and h.stride() == (3 * 24 * ldb, 24 * ldb, ldb, 1)
    assert h.is_contiguous() == (oc % 8 == 0)
    if oc % 8:  # the storage beyond OC holds zeros
        full = h.as_strided((3, 3, 24, ldb), h.stride())
        assert torch.equal(full[..., :oc], h) and not full[..., oc:].any()
    assert torch.equal(HWIO.inv(h), w) and HWIO.inv(h).is_contiguous()
    # a 1x1's (C, OC) view, as the k1conv rule reads it, keeps the row stride
    one = HWIO.prep(w[:, :, :1, :1])
    assert check_rows("b", one.reshape(24, -1), one.device, dt, (24, oc)) == ldb


def test_check_rows_refuses_what_is_not_rows():
    t = torch.zeros(16, 24)
    assert check_rows("b", t, t.device, t.dtype, (16, 24)) == 24
    assert check_rows("b", t[:, :20], t.device, t.dtype, (16, 20)) == 24
    assert check_rows("b", t[::2, :20], t.device, t.dtype, (8, 20)) == 48
    for bad, shape in ((t.t(), (24, 16)), (t[:, ::2], (16, 12))):
        with pytest.raises(ValueError, match="not rows"):
            check_rows("b", bad, t.device, t.dtype, shape)
    with pytest.raises(ValueError, match="shape"):
        check_rows("b", t, t.device, t.dtype, (16, 25))
    assert pad_rows(t).is_contiguous() and pad_rows(t[:, :20]).stride() == (24, 1)


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (1, 1, 0), (3, 2, 1)])
def test_gradient_through_the_prep_equals_the_dense_one(k, s, p):
    # the training conv on the padded filters (the prep's view, autograd
    # through pad_rows) against the dense HWIO filters, on the plain versions
    rng = np.random.default_rng(k + s)
    x0 = torch.from_numpy(rng.standard_normal((2, 9, 9, 16)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((84, 16, k, k)).astype(np.float32) * 0.1)
    b0 = torch.from_numpy(rng.standard_normal(84).astype(np.float32) * 0.1)
    g = None
    grads = []
    for prep in (HWIO.prep, lambda w: w.permute(2, 3, 1, 0).contiguous()):
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        out = gen_conv(x, prep(w), b, stride=(s, s), pad=(p, p))
        if g is None:
            g = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32))
        (out * g).sum().backward()
        grads.append((out.detach(), x.grad, w.grad, b.grad))
    for got, want in zip(*grads):
        assert torch.equal(got, want)
    # and against the plain conv's own autograd on the logical filters
    w = w0.clone().requires_grad_(True)
    (conv2d_plain(x0, w.permute(2, 3, 1, 0), b0, stride=(s, s), pad=(p, p)) * g).sum().backward()
    assert torch.allclose(grads[0][2], w.grad, rtol=1e-5, atol=1e-5 * float(w.grad.abs().max()))


def _heads_net(NetBuilder, Dims, ConvOp):
    """16 channels at 9x9 into convs of 84 and 126 output channels: a 3x3
    (ReLU fused), a strided 3x3, a 1x1 (K1's GEMM) and a 3x3 on the first's
    84 channels (C and N both off 8: the mma.sync loop), as ssd300's heads
    and their neighbours."""
    b = NetBuilder("edge_heads")
    t = b.input("data")
    a = b.conv("conf_a", t, 84, 3, pad=1, in_chans=16, relu=True)
    b.conv("conf_b", t, 126, 3, stride=2, pad=1, in_chans=16)
    b.conv("conf_c", t, 84, 1, in_chans=16)
    b.conv("conf_d", a, 126, 3, pad=1, in_chans=84)
    in_dims = {"data": Dims.of(img=2, chan=16, y=9, x=9)}
    return b.done(in_dims), in_dims


def test_nhwc_rule_at_oc_84_and_126_matches_boda_tpu():
    jp, jd = _heads_net(JNetBuilder, JDims, JConvOp)
    tp, td = _heads_net(TNetBuilder, TDims, TConvOp)
    weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
    x = np.random.RandomState(25).randn(*jd["data"].shape).astype(np.float32)
    nodes = ["conf_a", "conf_b", "conf_c", "conf_d"]
    je = jmake("conv_fwd", "pallas", kernel_policy="gen")
    je.init(jp)
    jr = je.run_fwd({"data": JNDA(jd["data"], x)}, nodes)
    te = tmake("conv_fwd", "cuda", device="cpu")
    te.init(tp)
    tr = te.run_fwd({"data": TNDA(td["data"], x)}, nodes)
    for n in nodes:
        a, b = jr[n].data, tr[n].data
        assert a.shape == b.shape, n
        r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * float(np.abs(a).max()))
        assert r.ok() and r.num_diff == 0, f"node {n}: {r}"
    # the engine holds every filter of OC % 8 != 0 in padded rows
    for n in nodes:
        w = te._weights_dev[f"{n}__filts"]
        oc = w.shape[3]
        assert check_rows("w", w, w.device, w.dtype, tuple(w.shape)) == cdiv(oc, 8) * 8
    log = te.get_info_log()
    assert "conf_c: nhwc-k1conv" in log and "conf_a: nhwc-direct_conv" in log
