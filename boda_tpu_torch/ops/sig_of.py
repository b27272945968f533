"""Graph op -> rtc-layer op signature mapping.

A copy of ``boda_tpu/ops/sig_of.py`` on the port's ConvPipe: the same
signatures, so corpora and wisdom keys agree between the packages. The
bridge between the whole-net engines and the per-op autotuning world: a
Convolution/InnerProduct graph op maps to the standalone rtc op signature
(ref: ops-prof corpora are exactly these signatures; rtc_fwd.cc:246
``write_sigs`` records them during net runs)."""

from __future__ import annotations

from ..graph.pipe import ConvOp, ConvPipe
from ..utils.dims import Dims
from .op_base import Op


def rtc_sig_of(pipe: ConvPipe, op: ConvOp) -> Op | None:
    """Signature for matmul-shaped graph ops; None for others."""
    if op.type == "InnerProduct":
        ind = pipe.must_dims(op.bots[0])
        fd = pipe.must_dims(op.bots[1])
        M, K, N = ind["img"], fd["in_feats"], fd["out_chan"]
        return Op("sgemm", {}, {"a": Dims.of(M=M, K=K, tn=ind.tn),
                                "b": Dims.of(K=K, N=N, tn=ind.tn),
                                "c": Dims.of(M=M, N=N, tn=ind.tn)})
    if op.type == "Convolution":
        ind = pipe.must_dims(op.bots[0])
        fd = pipe.must_dims(op.bots[1])
        od = pipe.must_dims(op.tops[0])
        return Op("conv", {"stride": str(op.stride()[0]),
                           "pad": str(op.pad()[0])},
                  {"in": ind, "filts": fd, "out": od,
                   "biases": Dims.of(out_chan=fd["out_chan"], tn=ind.tn)})
    return None


def collect_net_sigs(pipe: ConvPipe) -> list[Op]:
    """All unique matmul-shaped op signatures in a net (corpus generation,
    the to-prof-ops-gen analog, ref pysrc/to-prof-ops-gen.py)."""
    seen: dict[str, Op] = {}
    for op_name in pipe.topo_op_order():
        sig = rtc_sig_of(pipe, pipe.ops[op_name])
        if sig is not None and sig.key() not in seen:
            seen[sig.key()] = sig
    return list(seen.values())
