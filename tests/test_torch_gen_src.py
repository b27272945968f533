"""The engine's ``gen_src_dir`` (boda_tpu: executor.py:64, :283-296) on the
CPU: tinynet through run_cnet with ``(mode=cuda,device=cpu,gen_src_dir=gs)``
writes ``<pipe>_<hash>.plan.txt`` under the mode's output dir, listing every
op of the pipe in topo order (each run op with its rule, bots, tops and its
kernel entry or library calls; the ops fused into a chain named as such),
once per key, with boda_tpu's info-log line. On the card the captured graph
and the kernels' PTX are written beside it (chip_smoke.py [mesh]).
"""

import contextlib
import io
import os
import re

import numpy as np

from boda_tpu_torch import cli
from boda_tpu_torch.config import make
from boda_tpu_torch.frontend.pipe_builder import pipe_from_prototxt
from boda_tpu_torch.utils.dims import NDA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINYNET = os.path.join(REPO, "testdata", "nets", "tinynet.prototxt")


def test_run_cnet_writes_the_plan(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["run_cnet", f"--ptt-fn={TINYNET}", "--img=1",
                       f"--boda-output-dir={tmp_path}",
                       "--conv-fwd=(mode=cuda,device=cpu,gen_src_dir=gs)"])
    assert rc == 0
    files = os.listdir(tmp_path / "gs")
    assert len(files) == 1 and re.fullmatch(r"tinynet_[0-9a-f]{4}\.plan\.txt", files[0])
    assert f"gen_src: wrote {files[0]}" in out.getvalue()
    text = (tmp_path / "gs" / files[0]).read_text().splitlines()
    pipe = pipe_from_prototxt(TINYNET)[0]
    heads = [ln.split(":")[0].split() for ln in text if re.match(r"\d+ ", ln)]
    assert heads == [[str(i), n, pipe.ops[n].type]
                     for i, n in enumerate(pipe.topo_op_order())]
    assert "1 relu1 ReLU: fused into conv1" in text
    body = "\n".join(text)
    assert "kernel: K2 conv2d_halo route=plain" in body  # the convs' hand kernel
    assert "kernel: K1 matmul route=plain" in body       # the fc's
    assert "rule: nhwc-direct_conv" in body and "kernel: library " in body


def test_once_per_key_and_lib_calls(tmp_path):
    """A second forward of a key writes nothing; a new key (other outputs)
    writes its own plan; under kernel_policy=lib the convs name the
    library's calls."""
    pipe = pipe_from_prototxt(TINYNET)[0]
    d = pipe.nodes["data"].dims
    eng = make("conv_fwd", "cuda", device="cpu", kernel_policy="lib",
               gen_src_dir=str(tmp_path))
    eng.init(pipe)
    x = {"data": NDA(d, np.random.RandomState(0).randn(*d.shape).astype(np.float32))}
    eng.run_fwd(x, ["prob"])
    eng.run_fwd(x, ["prob"])
    assert len(os.listdir(tmp_path)) == 1
    eng.run_fwd(x, ["prob", "conv1"])
    plans = sorted(os.listdir(tmp_path))
    assert len(plans) == 2 and eng.get_info_log().count("gen_src: wrote") == 2
    text = "\n".join((tmp_path / p).read_text() for p in plans)
    assert "kernel: library torch.conv2d" in text and "kernel: K" not in text
