"""Serving on the card (boda_tpu_torch/modes/serve_bench.py): the captured
preprocess+net bit-equal to the engine's replay of the host preprocess, with
the forward's launches; pinned uploads on a stream of their own; a pipelined
run's last batch bit-equal to a serial one; the serve_stages rates.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. On the
machine with the card, from the repo root:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_serve.py``.
"""

import numpy as np
import pytest
import torch

from boda_tpu_torch.apps.preproc import img_to_batch_np
from boda_tpu_torch.config import make
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.modes.serve_bench import (ServedNet, Uploader, cached_batches,
                                              loader_batches, pinned_cache, serve_batches,
                                              stage_rates, stage_report)
from boda_tpu_torch.ops.kernels import conv, sgemm
from boda_tpu_torch.utils.dims import NDA

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (pinned memory, streams and CUDA graphs)")
    return torch.device("cuda")


def _net(compute_tn, batch=4):
    pipe, in_dims = build_model("mini_resnet", img=batch)
    eng = make("conv_fwd", "cuda", compute_tn=compute_tn)
    eng.init(pipe)
    return eng, in_dims["data"]


def _u8(d, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (d["img"], d["y"], d["x"], 4), dtype=np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("compute_tn", ["", "bfloat16"])
def test_served_forward_bit_equal_to_replay(dev, compute_tn):
    eng, d = _net(compute_tn)
    eng.prepare({"data": NDA(d, img_to_batch_np(_u8(d, 1)[0]))}, ["fc"])
    for f in (sgemm.matmul, conv.conv2d):
        f.launches = 0
    eng.run_fwd({"data": NDA(d, img_to_batch_np(_u8(d, 1)[0]))}, ["fc"])
    ref_counts = (sgemm.matmul.launches, conv.conv2d.launches)
    served = ServedNet(eng, "fc", d["img"], d["y"], d["x"])
    served.prepare()
    for f in (sgemm.matmul, conv.conv2d):
        f.launches = 0
    served.capture()
    assert (sgemm.matmul.launches, conv.conv2d.launches) == ref_counts
    for b in _u8(d, 2, seed=1):
        got = served.run(torch.from_numpy(b).to(dev)).float().cpu().numpy()
        want = eng.run_fwd({"data": NDA(d, img_to_batch_np(b))}, ["fc"])["fc"].data
        assert np.array_equal(got, want)


def test_pipeline_pinned_stream_and_last_batch(dev):
    eng, d = _net("bfloat16")
    served = ServedNet(eng, "fc", d["img"], d["y"], d["x"]).build()
    shape = (d["img"], d["y"], d["x"], 4)
    up = Uploader(shape, dev, 3)
    cache = pinned_cache(_u8(d, 3, seed=2), dev)
    assert all(h.is_pinned() for h in up.host + cache)
    assert up.stream.cuda_stream != torch.cuda.current_stream().cuda_stream
    with pytest.raises(RuntimeError, match="not in pinned memory"):
        up.upload(0, torch.zeros(shape, dtype=torch.uint8))
    n, last = serve_batches(served, up, cached_batches(cache, 7), 2)
    assert n == 7
    want = eng.run_fwd({"data": NDA(d, img_to_batch_np(cache[6 % 3].numpy()))}, ["fc"])
    assert np.array_equal(last.float().cpu().numpy(), want["fc"].data)
    st = stage_rates(served, up, cache, 5, 2)
    rep = stage_report(st, d["img"], 5, int(np.prod(shape)), None)
    assert set(rep) == {"h2d_img_s", "h2d_GB_s", "dispatch_img_s", "overlapped_img_s",
                        "overlap_quality"}
    assert all(v > 0 for v in rep.values())
    assert np.array_equal(st["ovl_out"].float().cpu().numpy(),
                          eng.run_fwd({"data": NDA(d, img_to_batch_np(cache[4 % 3].numpy()))},
                                      ["fc"])["fc"].data)


class PoolLoader:
    """Stands in for utils/native.BatchLoader: ``next(out=)`` writes batch i,
    ``pool[i % len(pool)]``, into ``out`` (a pinned buffer's numpy view), for
    ``n`` batches."""

    def __init__(self, pool, n):
        self.pool, self.n, self.i = pool, n, 0

    def next(self, out):
        if self.i == self.n:
            return None
        out[...] = self.pool[self.i % len(self.pool)]
        self.i += 1
        return self.i - 1, out


@pytest.mark.parametrize("n_bufs,depth", [(3, 2), (1, 3)])
def test_loader_refills_pinned_buffers_in_order(dev, n_bufs, depth):
    """loader_batches over more batches than pinned buffers: a buffer is
    refilled only after the upload that read it (with 1 buffer and 3
    batches in flight, an upload waits for the replay before it, so a
    refill that did not wait for the upload would overwrite the batch
    before its copy), and every served output is the engine's replay of
    the batch the loader wrote. Each replay is preceded by ~1 ms of
    device sleep, so the card lags the host as a full-width net does."""
    eng, d = _net("bfloat16")
    served = ServedNet(eng, "fc", d["img"], d["y"], d["x"]).build()
    run = served.run

    def slow_run(u8=None, ready=None):
        torch.cuda._sleep(2_000_000)
        return run(u8, ready)
    served.run = slow_run
    pool = _u8(d, 4, seed=3)
    want = [eng.run_fwd({"data": NDA(d, img_to_batch_np(b))}, ["fc"])["fc"].data
            for b in pool]
    assert all(not np.array_equal(want[j], want[k]) for j in range(4) for k in range(j))
    up = Uploader((d["img"], d["y"], d["x"], 4), dev, n_bufs)
    outs = []
    n, _ = serve_batches(served, up, loader_batches(PoolLoader(pool, 12), up), depth,
                         outs=outs)
    assert n == len(outs) == 12
    for i, o in enumerate(outs):
        assert np.array_equal(o.float().cpu().numpy(), want[i % len(pool)]), i
