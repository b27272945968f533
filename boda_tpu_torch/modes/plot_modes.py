"""Analysis/plot modes: roofline and wisdom-efficiency plots.

Counterpart of ``boda_tpu/modes/plot_modes.py``. Parity targets: ref
pysrc/roofline_plot.py, wis-plot.py, op-eff-plot.py — per-op efficiency and
roofline charts from cnn-prof/wisdom data. The roofline's peaks default to
the card's: an NVIDIA H100 SXM's published dense bf16 rate and HBM3 bandwidth
(NVIDIA's data sheet). matplotlib is optional: without it both modes raise
an error that names it.
"""

from __future__ import annotations

from ..config import ConfigError, Field, Mode, register
from ..utils.features import is_feature_enabled
from .cnet import load_net

# NVIDIA H100 SXM, dense (NVIDIA's data sheet): bf16 tensor-core FLOP/s and
# HBM3 bytes/s
CARD_PEAK_FLOPS, CARD_PEAK_BW = 989e12, 3.35e12


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or the feature error."""
    if not is_feature_enabled("matplotlib"):
        raise RuntimeError("matplotlib feature not enabled in this build (the "
                           "matplotlib python module is not installed); the plot "
                           "modes need it")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


@register("mode", "roofline_plot", help="roofline chart of a net's conv/fc ops")
class RooflinePlot(Mode):
    model = Field(str, default="", help="zoo model")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    img = Field(int, default="1", help="batch size")
    peak_flops = Field(float, default="0", help="peak FLOP/s (0: the card's, an NVIDIA "
                                                 "H100 SXM's dense bf16 989e12)")
    peak_bw = Field(float, default="0", help="memory bandwidth B/s (0: the card's, an "
                                             "NVIDIA H100 SXM's HBM3 3.35e12)")
    out_fn = Field(str, default="roofline.png", help="output chart")
    wisdom_fn = Field("filename", default="", help="wisdom file: plot measured points")

    def main(self) -> None:
        import numpy as np
        plt = _pyplot()
        peak_flops = self.peak_flops or CARD_PEAK_FLOPS
        peak_bw = self.peak_bw or CARD_PEAK_BW
        pipe, _ = load_net(self.model, self.ptt_fn, "", self.img, 0)
        ais, names = [], []
        for op_name in pipe.topo_op_order():
            op = pipe.ops[op_name]
            if op.type not in ("Convolution", "InnerProduct"):
                continue
            fl = pipe.op_flops(op_name)
            byts = sum(pipe.must_dims(b).bytes_sz() for b in op.bots) + \
                sum(pipe.must_dims(t).bytes_sz() for t in op.tops)
            ais.append(fl / max(byts, 1))
            names.append(op_name)
        fig, ax = plt.subplots(figsize=(8, 5))
        x = np.logspace(-1, 3, 200)
        roof = np.minimum(peak_flops, x * peak_bw)
        ax.loglog(x, roof, "k-", lw=2, label="roofline")
        ridge = peak_flops / peak_bw
        ax.axvline(ridge, color="gray", ls=":", lw=1)
        for ai in ais:
            ax.axvline(ai, color="tab:blue", alpha=0.25, lw=1)
        # measured points from wisdom (best tune per op)
        if self.wisdom_fn:
            from ..prof.wisdom import read_wisdom
            from ..ops.sig_of import rtc_sig_of
            wis = {w.op.key(): w for w in read_wisdom(self.wisdom_fn)}
            for op_name in names:
                sig = rtc_sig_of(pipe, pipe.ops[op_name])
                w = wis.get(sig.key()) if sig else None
                if w and w.best():
                    fl = pipe.op_flops(op_name)
                    byts = sum(pipe.must_dims(b).bytes_sz()
                               for b in pipe.ops[op_name].bots) + \
                        sum(pipe.must_dims(t).bytes_sz()
                            for t in pipe.ops[op_name].tops)
                    ax.plot(fl / max(byts, 1), fl / w.best().secs, "o",
                            color="tab:red", ms=4)
        ax.set_xlabel("arithmetic intensity (FLOP/byte)")
        ax.set_ylabel("FLOP/s")
        ax.set_title(f"{pipe.name} roofline (peak {peak_flops / 1e12:.1f} TF/s)")
        ax.legend()
        fig.tight_layout()
        fig.savefig(self.out_path(self.out_fn), dpi=110)
        print(f"roofline_plot: {len(ais)} ops -> {self.out_fn}")


@register("mode", "wis_plot", help="per-op tune-runtime scatter from a wisdom file")
class WisPlot(Mode):
    wisdom_fn = Field("filename", req=True, help="wisdom file")
    out_fn = Field(str, default="wisdom.png", help="output chart")

    def main(self) -> None:
        from ..prof.wisdom import read_wisdom
        plt = _pyplot()
        wis = read_wisdom(self.wisdom_fn)
        if not wis:
            raise ConfigError("empty wisdom file")
        fig, ax = plt.subplots(figsize=(10, 5))
        tunes = sorted({r.tune for w in wis for r in w.runs})
        colors = plt.cm.tab10(range(len(tunes)))
        for ti, tune in enumerate(tunes):
            xs, ys = [], []
            for i, w in enumerate(wis):
                for r in w.runs:
                    if r.tune == tune:
                        xs.append(i)
                        ys.append(r.secs * 1e6)
            ax.plot(xs, ys, "o", ms=4, color=colors[ti], label=tune or "(default)")
        ax.set_yscale("log")
        ax.set_xlabel("op index")
        ax.set_ylabel("runtime (us)")
        ax.set_title("per-op runtimes by tune")
        ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(self.out_path(self.out_fn), dpi=110)
        print(f"wis_plot: {len(wis)} ops, {len(tunes)} tunes -> {self.out_fn}")
