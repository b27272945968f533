"""The zoo's GoogLeNet, VGG, AlexNet, NiN, SqueezeNet and firenet builders
against boda_tpu's, on the CPU: bit-identical seeded weights, the same
cnet_ana text, and the cnet_ana goldens (testdata/good_tr, the commands of
testdata/test_cmds.xml:5,7). Their forwards: tests/test_torch_zoo_forward.py."""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu.models.zoo import MODELS as JMODELS
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.modes.cnet import CnetAna as JCnetAna
from boda_tpu_torch import cli
from boda_tpu_torch.models.zoo import MODELS as TMODELS
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.modes.cnet import CnetAna as TCnetAna

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOOD = os.path.join(REPO, "testdata", "good_tr")

# the smallest size each builder takes at its published widths (alexnet's
# fc6 is sized for 227, VGG's fc6 follows in_sz // 32)
_NETS = {"alexnet_ng_conv": {}, "nin_imagenet": {"in_sz": 64},
         "googlenet_conv": {"in_sz": 64}, "vgg16": {"in_sz": 64}, "vgg19": {"in_sz": 64},
         "squeezenet": {"in_sz": 64}, "firenet": {"in_sz": 64}}


def test_models_registered_as_in_boda_tpu():
    """Every builder of boda_tpu's zoo under its name, but ssd300 (its SSD
    head's rules are ROADMAP §1 item 6)."""
    assert sorted(TMODELS) == sorted(set(JMODELS) - {"ssd300"})


def test_zoo_weights_identical():
    for name in sorted(_NETS):
        _weights_identical(name)


def _weights_identical(name):
    jp, _ = jbuild(name, img=2, **_NETS[name])
    tp, _ = tbuild(name, img=2, **_NETS[name])
    assert list(jp.ops) == list(tp.ops) and sorted(jp.weights) == sorted(tp.weights)
    for k, a in jp.ops.items():
        b = tp.ops[k]
        assert (a.type, a.params, a.bots, a.tops) == (b.type, b.params, b.bots, b.tops), k
    for k, w in jp.weights.items():
        d = tp.weights[k].dims
        assert (d.names, d.sizes, d.tn) == (w.dims.names, w.dims.sizes, w.dims.tn), k
        assert np.array_equal(tp.weights[k].data, w.data), k
    for n, node in jp.nodes.items():
        assert node.dims.sizes == tp.nodes[n].dims.sizes, n


def test_cnet_ana_matches():
    for name in sorted(_NETS):
        _cnet_ana_matches(name)


def _cnet_ana_matches(name):
    texts = []
    for cls in (JCnetAna, TCnetAna):
        mode = cls.__new__(cls)
        mode.model, mode.img, mode.print_ops = name, 2, True
        mode.in_sz = _NETS[name].get("in_sz", 0)
        mode.ptt_fn = mode.weights_fn = ""
        buf = io.StringIO()
        with redirect_stdout(buf):
            mode.main()
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert "total: ops=" in texts[1]


def test_cnet_ana_golden(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for name, model in (("cnet_ana_alexnet", "alexnet_ng_conv"),
                        ("cnet_ana_googlenet", "googlenet_conv")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main(["cnet_ana", f"--model={model}", "--img=1"]) == 0
        with open(os.path.join(GOOD, name, "test_out.txt")) as f:
            assert buf.getvalue() == f.read(), name
