"""The port's entry points on the CPU: the CLI, the import rule and the
device rule."""

import os
import subprocess
import sys

import pytest
import torch

from boda_tpu_torch.config import make
from boda_tpu_torch.models.zoo import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


def test_run_cnet_cli_on_cpu():
    r = _run(["-m", "boda_tpu_torch", "run_cnet", "--model=mini_resnet",
              "--conv-fwd=(mode=cuda,device=cpu)"])
    assert r.returncode == 0, r.stderr
    assert "out prob dims=(img=1,chan=16)" in r.stdout
    assert "nhwc-k1conv" in r.stdout and "nhwc-direct_conv" in r.stdout


def test_cli_help_and_unused_key():
    r = _run(["-m", "boda_tpu_torch", "run_cnet", "--help"])
    assert r.returncode == 0 and "--conv_fwd" in r.stdout
    r = _run(["-m", "boda_tpu_torch", "run_cnet", "--model=mini_resnet",
              "--conv-fwd=(mode=cuda,device=cpu,typo_knob=1)"])
    assert r.returncode == 1 and "unused config key" in r.stderr


_HYGIENE = """
import sys
import boda_tpu_torch.cli, boda_tpu_torch.modes_all
import boda_tpu_torch.modes.test_compute, boda_tpu_torch.utils.digest
import boda_tpu_torch.ops.kernels.bconv, boda_tpu_torch.ops.kernels.stem
import boda_tpu_torch.modes.rtc, boda_tpu_torch.modes.prof, boda_tpu_torch.prof.abtime
import boda_tpu_torch.frontend.pipe_builder, boda_tpu_torch.frontend.surgery
import boda_tpu_torch.modes.surgery_modes
import boda_tpu_torch.graph.ssd_ops, boda_tpu_torch.apps.scoring
import boda_tpu_torch.modes.detect, boda_tpu_torch.modes.apps
import boda_tpu_torch.parallel.train, boda_tpu_torch.parallel.checkpoint
import boda_tpu_torch.parallel.schedules, boda_tpu_torch.graph.train_ops
import boda_tpu_torch.modes.train_lmdb, boda_tpu_torch.modes.train_bench
import boda_tpu_torch.ops.kernels.train_conv
import boda_tpu_torch.modes.net_trace, boda_tpu_torch.modes.cnn_prof
import boda_tpu_torch.modes.net_tune, boda_tpu_torch.modes.ipc_modes
import boda_tpu_torch.rtc.ipc, boda_tpu_torch.rtc.stream_util
import boda_tpu_torch.utils.native, boda_tpu_torch.apps.preproc
import boda_tpu_torch.modes.serve_bench, boda_tpu_torch.modes.zmq_modes
import boda_tpu_torch.apps.zmq_det, boda_tpu_torch.modes.basic
import boda_tpu_torch.apps.pyramid, boda_tpu_torch.apps.pred_state
import boda_tpu_torch.modes.test_cmds
import boda_tpu_torch.stream.data_stream, boda_tpu_torch.stream.velodyne
import boda_tpu_torch.stream.avi, boda_tpu_torch.stream.rosbag
import boda_tpu_torch.modes.stream_modes, boda_tpu_torch.modes.display_modes
import boda_tpu_torch.modes.proc_pipe, boda_tpu_torch.modes.plot_modes
import boda_tpu_torch.parallel.mesh, boda_tpu_torch.parallel.dryrun
import boda_tpu_torch.modes.dist_modes
import boda_tpu_torch.ops.cnn_variants, boda_tpu_torch.graph.lowering
import tempfile
from boda_tpu_torch import cli
from boda_tpu_torch.config import make
from boda_tpu_torch.graph.autodiff import add_bck_ops
from boda_tpu_torch.modes.cnet import gen_data_inputs
from boda_tpu_torch.models.zoo import build_model
pipe, in_dims = build_model("mini_resnet", img=1)
eng = make("conv_fwd", "cuda", device="cpu")
eng.init(pipe)
out = eng.run_fwd(gen_data_inputs(in_dims), ["prob"])
assert out["prob"].data.shape == (1, 16)
pipe, in_dims = build_model("mini_resnet", img=1, in_sz=8)
add_bck_ops(pipe)
in_dims["label"] = pipe.nodes["label"].dims
eng = make("conv_fwd", "cuda", device="cpu")
eng.init(pipe)
out = eng.run_fwd(gen_data_inputs(in_dims), ["data__grad__p0", "prob_loss"])
assert out["data__grad__p0"].data.shape == (1, 3, 8, 8)
assert "bck-conv" in eng.get_info_log()
for kw in ({}, {"layout": "nchw", "kernel_policy": "gen"}):
    eng = make("conv_fwd", "xla" if not kw else "pallas", platform="cpu", **kw)
    eng.init(pipe)
    out = eng.run_fwd(gen_data_inputs(in_dims), ["data__grad__p0", "prob_loss"])
    assert out["data__grad__p0"].data.shape == (1, 3, 8, 8)
assert "k1conv" in eng.get_info_log()
assert cli.main(["run_cnet", "--model=mini_resnet", "--img=2",
                 "--conv-fwd=(mode=pallas,int8=1,platform=cpu)"]) == 0
assert cli.main(["test_compute", "--model=mini_resnet", "--img=1", "--n-wins=1",
                 "--engines=(oracle=(mode=xla,platform=cpu),"
                 "pallas=(mode=pallas,layout=nchw,kernel_policy=gen,platform=cpu))"]) == 0
assert cli.main(["rtc_test", "--be=(be=cuda,device=cpu)", "--n=1000"]) == 0
assert cli.main(["run_cnet", "--ptt-fn=testdata/nets/shapesnet.prototxt",
                 "--weights-fn=testdata/nets/shapesnet.caffemodel",
                 "--conv-fwd=(mode=cuda,device=cpu)"]) == 0
with tempfile.TemporaryDirectory() as td:
    assert cli.main(["cnet_detect", "--ptt-fn=testdata/nets/tinyssd.prototxt",
                     "--conf-thresh=0.3", "--conv-fwd=(mode=cuda,device=cpu)",
                     "--boda-output-dir=" + td, "--gt-fn=testdata/score/gt.txt"]) == 0
assert cli.main(["score", "--dets-fn=testdata/score/dets.txt",
                 "--gt-fn=testdata/score/gt.txt"]) == 0
assert cli.main(["train_bench", "--model=mini_resnet", "--img=2", "--chain=2",
                 "--compute_tn=", "--golden_out=1", "--device=cpu"]) == 0
with tempfile.TemporaryDirectory() as td:
    assert cli.main(["train_lmdb", "--rec-fn=testdata/lmdb/cifar_mini.rec",
                     "--model=mini_resnet", "--img=2", "--n-steps=2", "--device=cpu",
                     "--ckpt-fn=ck.npz", "--boda-output-dir=" + td]) == 0
    assert cli.main(["test_lmdb", "--rec-fn=testdata/lmdb/cifar_mini.rec",
                     "--model=mini_resnet", "--img=2", "--ckpt-fn=" + td + "/ck.npz",
                     "--conv-fwd=(mode=cuda,device=cpu)"]) == 0
with tempfile.TemporaryDirectory() as td:
    assert cli.main(["net_trace", "--model=mini_resnet", "--img=2", "--n-iters=1",
                     "--per-op=1", "--conv-fwd=(mode=cuda,device=cpu)",
                     "--boda-output-dir=" + td]) == 0
    assert cli.main(["train_trace", "--model=mini_resnet", "--img=2", "--n-iters=1",
                     "--device=cpu", "--boda-output-dir=" + td]) == 0
assert cli.main(["cs_test_master", "--worker-be=(be=cuda,device=cpu)", "--n=100"]) == 0
with tempfile.TemporaryDirectory() as td:
    assert cli.main(["serve_stages", "--model=mini_resnet", "--img=2", "--n-batches=2",
                     "--img-fns=(a=testdata/images/test2.jpg)",
                     "--conv-fwd=(mode=cuda,device=cpu)", "--boda-output-dir=" + td]) == 0
    assert cli.main(["cnet_predict", "--model=mini_resnet", "--enable-upsamp-net=1",
                     "--img-fns=(a=testdata/images/test1.png)",
                     "--conv-fwd=(mode=cuda,device=cpu)"]) == 0
    assert cli.main(["predict_dense", "--annos=1", "--model=mini_resnet", "--plane-sz=64",
                     "--img-fn=testdata/images/test1.png", "--min-sz=32",
                     "--conv-fwd=(mode=cuda,device=cpu)", "--boda-output-dir=" + td]) == 0
    assert cli.main(["test_cmds", "--filt=^(noop|blf_pack_basic|display_pil|err_no_camera|"
                     "cs_disp_pipeline|render_pts_velo|hash_pair_check|velodyne_gen_scan|"
                     "avi_mjpeg_scan|rosbag_scan_image|rosbag_scan|velo_scan_fixture|"
                     "stream_sync|stream_merge_flatten|stream_fold_sort|"
                     "stream_seq_adj_angle)$", "--boda-output-dir=" + td]) == 0
    assert cli.main(["roofline_plot", "--model=mini_resnet", "--boda-output-dir=" + td]) == 0
    assert cli.main(["compsup"]) == 0
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "boda_tpu")]
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    r = _run(["-c", _HYGIENE])
    assert r.returncode == 0, r.stdout + r.stderr


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pipe, _ = build_model("mini_resnet", img=1)
    eng = make("conv_fwd", "cuda")  # device defaults to cuda
    with pytest.raises(RuntimeError, match="no CUDA card"):
        eng.init(pipe)


def test_train_bench_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from boda_tpu_torch.modes.train_bench import TrainBench
    mode = make("mode", "train_bench", model="mini_resnet", img=2)  # device defaults to cuda
    assert isinstance(mode, TrainBench)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mode.main()


def test_cuda_backend_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    be = make("be", "cuda")  # device defaults to cuda, resolved at first use
    with pytest.raises(RuntimeError, match="no CUDA card"):
        be.get_plat_tag()
    assert make("be", "cuda", device="cpu").get_plat_tag() == "cuda:cpu"


def test_time_fwd_refuses_cpu():
    pipe, in_dims = build_model("mini_resnet", img=1)
    eng = make("conv_fwd", "cuda", device="cpu")
    eng.init(pipe)
    from boda_tpu_torch.modes.cnet import gen_data_inputs
    with pytest.raises(RuntimeError, match="times the card"):
        eng.time_fwd(gen_data_inputs(in_dims), ["prob"])
