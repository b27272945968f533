"""The port's zoo, cnet_ana and weight carry-over against boda_tpu's, on
the CPU: bit-identical seeded weights, identical per-op dims/FLOPs/bytes
lines, and weights_from_numpy's refusals."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.modes.cnet import CnetAna as JCnetAna
from boda_tpu_torch.graph.pipe import PipeError
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.modes.cnet import CnetAna as TCnetAna
from boda_tpu_torch.utils.carry import weights_from_numpy

_NETS = {"mini_resnet": {}, "resnet50": {"img": 1, "in_sz": 64}}


@pytest.mark.parametrize("name", sorted(_NETS))
def test_zoo_weights_identical(name):
    kw = _NETS[name]
    jp, _ = jbuild(name, **kw)
    tp, _ = tbuild(name, **kw)
    assert sorted(jp.weights) == sorted(tp.weights)
    for k, w in jp.weights.items():
        d = tp.weights[k].dims
        assert (d.names, d.sizes, d.tn) == (w.dims.names, w.dims.sizes, w.dims.tn), k
        assert np.array_equal(tp.weights[k].data, w.data), k


@pytest.mark.parametrize("name", ["mini_resnet", "resnet50"])
def test_cnet_ana_matches(name):
    texts = []
    for cls in (JCnetAna, TCnetAna):
        mode = cls.__new__(cls)
        mode.model, mode.img, mode.in_sz, mode.print_ops = name, 2, 0, True
        mode.ptt_fn = mode.weights_fn = ""
        buf = io.StringIO()
        with redirect_stdout(buf):
            mode.main()
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert "total: ops=" in texts[1]


def test_weights_from_numpy_rejects_mismatch():
    tp, _ = tbuild("mini_resnet")
    good = {k: w.data for k, w in tp.weights.items()}
    with pytest.raises(PipeError, match="missing"):
        weights_from_numpy(tp, {k: v for k, v in good.items() if k != "fc__filts"})
    bad = dict(good, fc__filts=good["fc__filts"].T)
    with pytest.raises(PipeError, match="shape"):
        weights_from_numpy(tp, bad)
    bad = dict(good, fc__filts=good["fc__filts"].astype(np.float64))
    with pytest.raises(PipeError, match="dtype"):
        weights_from_numpy(tp, bad)
