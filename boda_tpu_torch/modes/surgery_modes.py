"""Net-surgery modes: cnet_fc_to_conv, cnet_resize_conv, cnet_copy, cnet_util,
cnet_bpt_dump.

Counterpart of ``boda_tpu/modes/surgery_modes.py``, copied onto the port's
frontend (``frontend/surgery.py``, ``frontend/caffemodel.py``). Parity targets: ref src/caffepb.cc modes (:887, :823, :780, :991).
"""

from __future__ import annotations

import numpy as np

from ..config import ConfigError, Field, Mode, register
from .cnet import load_net


class _SurgeryMode(Mode):
    model = Field(str, default="", help="zoo model name")
    ptt_fn = Field("filename", default="", help="input prototxt")
    weights_fn = Field("filename", default="", help="input caffemodel")
    img = Field(int, default="1", help="batch size")
    in_sz = Field(int, default="0", help="input size override")
    out_ptt_fn = Field(str, default="out.prototxt", help="output prototxt name")
    out_weights_fn = Field(str, default="", help="output caffemodel name ('' = skip)")

    def write_net(self, pipe) -> None:
        from ..frontend.surgery import pipe_to_prototxt, write_caffemodel
        fn = self.out_path(self.out_ptt_fn)
        with open(fn, "w") as f:
            f.write(pipe_to_prototxt(pipe))
        print(f"wrote {self.out_ptt_fn}")
        if self.out_weights_fn:
            write_caffemodel(self.out_path(self.out_weights_fn), pipe)
            print(f"wrote {self.out_weights_fn}")


@register("mode", "cnet_copy", help="read a net (+weights) and rewrite it")
class CnetCopy(_SurgeryMode):
    def main(self) -> None:
        pipe, _ = load_net(self.model, self.ptt_fn, self.weights_fn,
                           self.img, self.in_sz)
        self.write_net(pipe)


@register("mode", "cnet_fc_to_conv", help="convert InnerProducts to Convolutions")
class CnetFcToConv(_SurgeryMode):
    def main(self) -> None:
        from ..frontend.surgery import fc_to_conv
        pipe, _ = load_net(self.model, self.ptt_fn, self.weights_fn,
                           self.img, self.in_sz)
        converted = fc_to_conv(pipe)
        for c in converted:
            op = pipe.ops[c]
            print(f"converted {c}: InnerProduct -> Convolution "
                  f"kern={op.kern_sz()} out={pipe.must_dims(op.tops[0])}")
        print(f"fc_to_conv: {len(converted)} layers converted")
        self.write_net(pipe)


@register("mode", "cnet_resize_conv", help="resample a conv layer's filters")
class CnetResizeConv(_SurgeryMode):
    layer = Field(str, req=True, help="Convolution op name to resize")
    new_kern = Field(int, req=True, help="new (square) kernel size")

    def main(self) -> None:
        from ..frontend.surgery import resize_conv
        pipe, _ = load_net(self.model, self.ptt_fn, self.weights_fn,
                           self.img, self.in_sz)
        if self.layer not in pipe.ops:
            raise ConfigError(f"no op named {self.layer!r}")
        old = pipe.ops[self.layer].kern_sz()
        resize_conv(pipe, self.layer, (self.new_kern, self.new_kern))
        print(f"resized {self.layer}: kern {old} -> "
              f"({self.new_kern},{self.new_kern})")
        self.write_net(pipe)


@register("mode", "cnet_util", help="dump per-layer weight statistics")
class CnetUtil(_SurgeryMode):
    def main(self) -> None:
        pipe, _ = load_net(self.model, self.ptt_fn, self.weights_fn,
                           self.img, self.in_sz)
        for name in sorted(pipe.weights):
            w = pipe.weights[name]
            d = w.data.astype(np.float64)
            print(f"{name:<36} {str(w.dims):<40} min={d.min():.5g} "
                  f"max={d.max():.5g} mean={d.mean():.5g} std={d.std():.5g}")
        print(f"cnet_util: {len(pipe.weights)} weight blobs, "
              f"{sum(w.dims.num_elems() for w in pipe.weights.values())} params")


@register("mode", "cnet_bpt_dump", help="dump a binary caffemodel as textproto")
class CnetBptDump(Mode):
    """Ref cnet_bpt_dump_t (caffepb.cc:709): read a trained binary
    NetParameter, optionally clear blob data, TextFormat-print it."""

    weights_fn = Field("filename", req=True, help="input caffemodel")
    remove_data = Field(bool, default="1", help="strip blob data fields")

    def main(self) -> None:
        import os

        from ..frontend.caffemodel import dump_textproto
        if not os.path.exists(self.weights_fn):
            raise ConfigError(
                f"can't open caffemodel file "
                f"{os.path.basename(self.weights_fn)!r}: no such file")
        with open(self.weights_fn, "rb") as f:
            print(dump_textproto(f.read(), remove_data=self.remove_data),
                  end="")
