"""test_compute: cross-engine per-layer numeric regression over real nets.

Counterpart of ``boda_tpu/modes/test_compute.py`` (``test_compute`` and
``comp_ndas``), run on the port's engines: by default the library path
(``kernel_policy=lib``, cuDNN/cuBLAS) is the baseline and the hand kernels
(``gen``) are held against it, node by node, forward and (with
``--add-bck-ops=1``) gradient. Digest streams are boda_tpu's format, so a
stream written by either package checks the other. Models come from the
zoo (--model=) or a Caffe prototxt (--ptt-fn=, --weights-fn=).

Parity target: ``test_compute_multi_t`` (ref src/test_compute.cc:24): run
inputs through the same net on several engines; (a) full-tensor compare every
layer vs engine[0] with per-layer MRD tolerances, (b) compare digests against
a stored known-good digest stream, (c) optionally (re)write the stream.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .. import graph  # noqa: F401  (registers the "conv_fwd" engines)
from ..config import Field, Mode, register
from ..utils.digest import DigestStream, NdaDigest, comp_vars
from ..utils.dims import NDA
from .cnet import load_net


@register("mode", "test_compute", help="cross-engine per-layer numeric regression")
class TestCompute(Mode):
    model = Field(str, default="", help="zoo model name")
    ptt_fn = Field("filename", default="", help="caffe prototxt path")
    weights_fn = Field("filename", default="", help="caffemodel path")
    img = Field(int, default="2", help="batch size")
    in_sz = Field(int, default="0", help="input size override")
    # the labels are boda_tpu's (its output line, which the corpus golden
    # test_compute_mini pins, names them): "oracle" is the library path,
    # "pallas" the hand kernels (kernel_policy=gen)
    engines = Field((dict, "conv_fwd"),
                    default="(oracle=(mode=cuda,kernel_policy=lib),"
                            "pallas=(mode=cuda,kernel_policy=gen))",
                    help="engines; first is the comparison baseline")
    n_wins = Field(int, default="2", help="number of input windows to test")
    mrd_toler = Field(float, default="5e-4", help="default per-layer tolerance")
    var_mrd_toler = Field((dict, float), default="()",
                          help="per-node tolerance overrides")
    kg_digests_fn = Field("filename", default="", help="stored known-good digest stream")
    write_digests_fn = Field("filename", default="", help="write digest stream (from engine[0])")
    max_nodes = Field(int, default="0", help="limit checked nodes (0=all)")
    add_bck_ops = Field(bool, default="0", help="also test gradient ops (graph autodiff)")

    def main(self) -> None:
        pipe, in_dims = load_net(self.model, self.ptt_fn, self.weights_fn,
                                 self.img, self.in_sz)
        if self.add_bck_ops:
            from ..graph.autodiff import add_bck_ops
            add_bck_ops(pipe)
            for bn in pipe.bots():  # e.g. the new 'label' input
                if bn not in in_dims and pipe.nodes[bn].dims is not None:
                    in_dims[bn] = pipe.nodes[bn].dims
        names = list(self.engines)
        engs = list(self.engines.values())
        for e in engs:
            e.init(pipe)
        check_nodes = [n for n, node in pipe.nodes.items()
                       if node.dims is not None and n not in pipe.weights
                       and node.top_for]
        if self.max_nodes:
            check_nodes = check_nodes[: self.max_nodes]

        kg = DigestStream.load(self.kg_digests_fn).as_dict() \
            if self.kg_digests_fn and os.path.exists(self.kg_digests_fn) else {}
        out_stream = DigestStream()
        n_fail = 0
        from ..ops.kernels.gen_data import gen_data_pattern
        for win in range(self.n_wins):
            ins = {}
            for name, d in in_dims.items():
                ins[name] = NDA(d, gen_data_pattern(
                    d.shape, d.tn, mod=13 + 2 * win, offset=win * 101)
                    .float().numpy())
            results = [e.run_fwd(ins, check_nodes) for e in engs]
            for node in check_nodes:
                base = results[0][node].data
                toler = self.var_mrd_toler.get(node, self.mrd_toler)
                scale = max(1e-30, float(np.abs(base).max()))
                for ei in range(1, len(engs)):
                    r = comp_vars(base, results[ei][node].data,
                                  mrd_toler=toler, atol=toler * scale)
                    if not r.ok():
                        n_fail += 1
                        print(f"FAIL win={win} node={node} "
                              f"{names[0]} vs {names[ei]}: {r}")
                tag = f"win{win}/{node}"
                d = NdaDigest.make(base, results[0][node].dims)
                out_stream.add(tag, base, results[0][node].dims)
                if tag in kg:
                    mrd = kg[tag].mrd_comp(d)
                    if mrd > toler:
                        n_fail += 1
                        print(f"FAIL win={win} node={node}: digest mrd {mrd:.3g} "
                              f"vs stored known-good (toler {toler:g})")
        if self.write_digests_fn:
            # resolve into the output dir (archived + digest-compared by the
            # golden harness); print the relative name for stable goldens
            out_stream.save(self.out_path(self.write_digests_fn))
            print(f"wrote {len(out_stream.entries)} digests to {self.write_digests_fn}")
        status = "PASS" if n_fail == 0 else f"FAIL ({n_fail} mismatches)"
        print(f"test_compute {pipe.name} engines={names} wins={self.n_wins} "
              f"nodes={len(check_nodes)}: {status}")
        if n_fail:
            sys.exit(1)


@register("mode", "comp_ndas", help="compare two digest streams with a tolerance")
class CompNdas(Mode):
    """ref comp-ndas (test_nesi.cc:91): tolerance-compare stored streams."""
    a_fn = Field("filename", req=True, help="first digest stream")
    b_fn = Field("filename", req=True, help="second digest stream")
    mrd_toler = Field(float, default="1e-5", help="max allowed digest mrd")

    def main(self) -> None:
        a = DigestStream.load(self.a_fn).as_dict()
        b = DigestStream.load(self.b_fn).as_dict()
        n_fail = 0
        if set(a) != set(b):
            print(f"entry sets differ: only-a={sorted(set(a)-set(b))} "
                  f"only-b={sorted(set(b)-set(a))}")
            n_fail += 1
        for k in sorted(set(a) & set(b)):
            mrd = a[k].mrd_comp(b[k])
            if mrd > self.mrd_toler:
                print(f"FAIL {k}: mrd {mrd:.3g} > {self.mrd_toler:g}")
                n_fail += 1
        print(f"comp_ndas: {len(set(a) & set(b))} entries, "
              f"{'PASS' if n_fail == 0 else f'{n_fail} FAILED'}")
        if n_fail:
            sys.exit(1)
