"""Net-level modes: analyze and run ConvPipe nets.

Counterpart of ``boda_tpu/modes/cnet.py``: ``cnet_ana`` (per-layer
shape/FLOPs dump) and ``run_cnet`` (build a net, run one forward, optionally
time it, write per-layer times and the net's op signatures). Models come
from the programmatic zoo (--model=); the prototxt frontend (--ptt-fn=) is
not ported yet.
"""

from __future__ import annotations

import json

from .. import graph  # noqa: F401  (registers the "conv_fwd" engines)
from ..config import ConfigError, Field, Mode, register
from ..utils.dims import NDA


def load_net(model: str, img: int, in_sz: int = 0):
    if not model:
        raise ConfigError("--model= (a zoo model name) is required")
    from ..models.zoo import build_model
    kw = {"img": img}
    if in_sz:
        kw["in_sz"] = in_sz
    return build_model(model, **kw)


def gen_data_inputs(in_dims) -> dict:
    """The gen_data pattern as host inputs (bf16 nodes held as f32)."""
    from ..ops.kernels.gen_data import gen_data_pattern
    return {name: NDA(d, gen_data_pattern(d.shape, d.tn).float().numpy())
            for name, d in in_dims.items()}


class _NetMode(Mode):
    model = Field(str, default="", help="zoo model name (e.g. resnet50)")
    img = Field(int, default="1", help="batch size (img dim)")
    in_sz = Field(int, default="0", help="input spatial size override (0=model default)")


@register("mode", "cnet_ana", help="per-layer shape/FLOPs/AI analysis of a net")
class CnetAna(_NetMode):
    print_ops = Field(bool, default="1", help="print per-op lines")

    def main(self) -> None:
        pipe, in_dims = load_net(self.model, self.img, self.in_sz)
        tot_flops = 0.0
        tot_bytes = 0.0
        rows = []
        for op_name in pipe.topo_op_order():
            op = pipe.ops[op_name]
            fl = pipe.op_flops(op_name)
            in_b = sum(pipe.must_dims(b).bytes_sz() for b in op.bots)
            out_b = sum(pipe.must_dims(t).bytes_sz() for t in op.tops)
            tot_flops += fl
            tot_bytes += in_b + out_b
            od = pipe.must_dims(op.tops[0])
            ai = fl / max(in_b + out_b, 1)
            rows.append((op_name, op.type, str(od), fl, ai))
        if self.print_ops:
            w = max(len(r[0]) for r in rows) + 1
            for name, typ, od, fl, ai in rows:
                print(f"{name:<{w}} {typ:<14} out={od:<34} "
                      f"flops={fl / 1e6:10.2f}M AI={ai:8.2f}")
        print(f"total: ops={len(rows)} flops={tot_flops / 1e9:.3f}G "
              f"bytes={tot_bytes / 1e6:.1f}M img={self.img}")


@register("mode", "run_cnet", help="run one forward pass of a net on an engine")
class RunCnet(_NetMode):
    conv_fwd = Field("conv_fwd", default="(mode=cuda)", help="forward engine")
    out_node_name = Field(str, default="prob", help="output node to fetch")
    n_iters = Field(int, default="0", help="if >0, also time n_iters forwards (card only)")
    dump_top_n = Field(int, default="5", help="print top-N of output")
    per_layer_fn = Field(str, default="", help="write per-layer times to this file (card only)")
    write_sigs_fn = Field(str, default="", help="append this net's op sigs to a corpus")

    def main(self) -> None:
        import numpy as np
        pipe, in_dims = load_net(self.model, self.img, self.in_sz)
        self.conv_fwd.init(pipe)
        ins = gen_data_inputs(in_dims)
        outs = self.conv_fwd.run_fwd(ins, [self.out_node_name])
        out = outs[self.out_node_name].data
        flat = out.reshape(out.shape[0], -1)
        top = np.argsort(-flat[0])[: self.dump_top_n]
        print(f"out {self.out_node_name} dims={outs[self.out_node_name].dims} "
              f"top{self.dump_top_n}={[(int(i), round(float(flat[0][i]), 5)) for i in top]}")
        if self.n_iters:
            import torch
            secs = self.conv_fwd.time_fwd(ins, [self.out_node_name],
                                          n_iters=self.n_iters)
            fl = pipe.total_flops()
            print(json.dumps({
                "net": pipe.name, "img": self.img, "secs_per_fwd": secs,
                "img_per_sec": round(self.img / secs, 2),
                "GF/s": round(fl / secs / 1e9, 1),
                "device": torch.cuda.get_device_name(),
            }))
        if self.write_sigs_fn:
            # append the op-signature corpus (ref write_sigs, rtc_fwd.cc:246)
            import os

            from ..ops.op_base import load_op_sigs, save_op_sigs
            from ..ops.sig_of import collect_net_sigs
            fn = self.out_path(self.write_sigs_fn)
            have = load_op_sigs(fn) if os.path.exists(fn) else []
            keys = {o.key() for o in have}
            new = [o for o in collect_net_sigs(pipe) if o.key() not in keys]
            save_op_sigs(fn, have + new)
            print(f"write_sigs: +{len(new)} sigs -> {self.write_sigs_fn} "
                  f"({len(have) + len(new)} total)")
        if self.per_layer_fn:
            times = self.conv_fwd.per_layer_times(ins)
            with open(self.out_path(self.per_layer_fn), "w") as f:
                for tag, secs in times.items():
                    # python-parseable format (ref rtc_fwd.cc:560-572)
                    f.write(f"per_layer_time['{tag}']={secs!r}\n")
            print(f"per-layer times: {len(times)} ops, sum {sum(times.values()) * 1e3:.3f}ms "
                  f"-> {self.per_layer_fn} (each op's unfused lowering alone, device "
                  "time in a CUDA graph)")
        il = self.conv_fwd.get_info_log()
        if il:
            print(il)
