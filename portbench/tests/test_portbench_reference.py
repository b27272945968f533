"""The plain references against the published counts and against the
program's plain CPU versions: the layer tables against the zoo's nets at
full size, ResNet-50's multiply-adds against He et al.'s 3.8e9, the f32
forward against the engine's eager CPU forward at a small input, SSD300's
priors and DetectionOutput against the program's on seeded head inputs."""

import numpy as np
import pytest
import torch

from portbench import harness as H
from portbench import work as W
from portbench.reference import common as RC
from portbench.reference import resnet50 as RN
from portbench.reference import ssd300 as SSD
from portbench.traffic.detect import matched_share

CFG_R = H.load_json(H.ROOT / "configs" / "resnet50.json")
CFG_S = H.load_json(H.ROOT / "configs" / "ssd300.json")
CPU = torch.device("cpu")


def _zoo_convs(pipe):
    out = {}
    for name, op in pipe.ops.items():
        if op.type not in ("Convolution", "InnerProduct"):
            continue
        ind, od, fd = (pipe.must_dims(b) for b in (op.bots[0], op.tops[0], op.bots[1]))
        if op.type == "InnerProduct":
            out[name] = (fd["in_feats"], fd["out_chan"], 1, 1, 0, 1, 1, 1)
        else:
            out[name] = (fd["in_chan"], fd["out_chan"], op.kern_sz()[0], op.stride()[0],
                         op.pad()[0], op.dilation()[0], ind["y"], od["y"])
    return out


@pytest.mark.parametrize("model,ref,cfg", [("resnet50", RN, CFG_R), ("ssd300", SSD, CFG_S)])
def test_layer_table_matches_the_zoo_at_full_size(model, ref, cfg):
    from boda_tpu_torch.models.zoo import build_model
    pipe, _ = build_model(model, img=1)
    zoo = _zoo_convs(pipe)
    table = {L["name"]: (L["c"], L["oc"], L["k"], L["stride"], L["pad"], L["dil"], L["h"],
                         L["oh"]) for L in ref.layers(cfg, 1)}
    assert table == zoo
    spec = {k: tuple(s) for k, s, _ in ref.spec(cfg)}
    assert spec == {k: tuple(w.dims.shape) for k, w in pipe.weights.items()}


def test_resnet50_multiply_adds_match_he_et_al():
    macs = W.model_flops(RN.layers(CFG_R, 1), False) / 2
    assert abs(macs / 3.8e9 - 1) < 0.03, macs


def test_ssd300_has_8732_priors():
    boxes, var = SSD.priors(CFG_S)
    assert boxes.shape == var.shape == (CFG_S["num_priors"], 4)


def test_resnet50_forward_matches_the_engine_on_the_cpu():
    from boda_tpu_torch.config import make
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.utils.carry import weights_from_numpy
    from boda_tpu_torch.utils.dims import NDA
    pipe, d = build_model("resnet50", img=2, in_sz=64)
    w = H.seeded_params(RN.spec(CFG_R), 2**31 + 5, CPU, torch.float32)
    weights_from_numpy(pipe, {k: v.numpy() for k, v in w.items()})
    eng = make("conv_fwd", "cuda", device="cpu")
    eng.init(pipe)
    x = RC.preprocess(H.seeded_images(7, "images", (2, 64, 64, 4), CPU))
    got = eng.run_fwd({"data": NDA(d["data"], x.numpy())}, ["fc1000"])["fc1000"].data
    with torch.no_grad():
        want = RN.forward(w, x, CFG_R).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _program_priors():
    from boda_tpu_torch.graph.ssd_ops import _compute_priors
    from boda_tpu_torch.models.zoo import build_model
    pipe, _ = build_model("ssd300", img=1)
    tabs = [_compute_priors(op, pipe.must_dims(op.bots[0]), pipe.must_dims(op.bots[1]))
            for op in (pipe.ops[n] for n in pipe.topo_op_order()) if op.type == "PriorBox"]
    return pipe, np.concatenate(tabs, axis=1)


def test_priors_equal_the_programs():
    _, tab = _program_priors()
    boxes, var = SSD.priors(CFG_S)
    assert np.array_equal(tab[0].reshape(-1, 4), boxes)
    assert np.array_equal(tab[1].reshape(-1, 4), var)


def test_detection_out_matches_the_programs_head():
    from boda_tpu_torch.graph.ssd_ops import _detection_output_fn
    pipe, tab = _program_priors()
    n, P, C = 2, CFG_S["num_priors"], CFG_S["num_classes"]
    g = torch.Generator().manual_seed(11)
    loc = torch.randn(n, P * 4, generator=g) * 0.5
    conf = torch.softmax(torch.randn(n, P, C, generator=g) * 3, dim=2).reshape(n, -1)
    fn = _detection_output_fn(pipe.ops["detection_out"], C, n, CPU)
    got = fn(loc, conf, torch.from_numpy(tab[None]))[0].reshape(n, -1, 7).numpy()
    want = SSD.detection_out(loc, conf, SSD.priors(CFG_S), CFG_S)
    assert (want[..., 1] >= 0).sum() > 100
    for i in range(n):
        assert matched_share(got[i], want[i]) == 0.0
    np.testing.assert_array_equal(got[..., :2], want[..., :2])


def test_control_quantizes_to_float8():
    x = torch.linspace(-3, 3, 101)
    q = RC.fp8(x)
    assert 0 < (q - x).abs().max() <= 3 / 448 * 32
    assert len(torch.unique(q)) < len(x)
