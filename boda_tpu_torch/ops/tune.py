"""The tuning knobs of the generated-kernel path.

Counterpart of ``boda_tpu/ops/tune.py`` ``OpTune``, with every knob of it,
the same names, defaults and declaration order, so ``key()`` is the same
string for the same tune and a tune written by ``boda_tpu`` (a wisdom file,
``ops_prof``'s ``op_tunes``, an engine's ``tune``) parses here. An unknown
knob is an error, as there. The knobs fall in three groups:

* read by the port: ``use_k1conv``, ``use_s2d`` (a strided conv on the
  space-to-depth fold), ``stem_s2d`` and ``pad_c`` (the stem on its fold,
  its channels padded), ``pool_pallas`` (the pooling kernel),
  ``precision`` (the library's f32 path; bf16 always runs bf16 inputs with
  an f32 accumulator), ``use_xla`` (the library op: cuDNN/cuBLAS) and
  ``int8`` (a conv or fc on int8 operands with an int32 accumulator, ahead
  of the kernel policy: graph/lowering_nhwc.py) and ``det_top_k``
  (DetectionOutput's NMS candidate count: graph/ssd_ops.py);
* no effect on the card (:data:`NO_EFFECT`): they choose between variants
  of boda_tpu's Pallas kernels with the same result (tile sizes, halo DMA
  or row gather, tap concatenation, image batching, the stem's im2col, the
  pooling emitter dodges, Mosaic's grid semantics), or are declared by
  boda_tpu and read by none of its kernels (``acc_tn``, ``in_tn``). The
  port's kernels have one form each with compile-time tiles, so these are
  parsed and kept in the key, and :meth:`OpTune.no_effect` names them for
  the logs.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

from ..utils.lexp import Lexp, parse_lexp


@dataclass(frozen=True)
class OpTune:
    # blocking: output tile sizes of boda_tpu's matmul-like kernels
    bm: int = 256
    bn: int = 256
    bk: int = 512
    # conv-specific spatial chunking (0=auto)
    chunk: int = 0
    # 1x1 pad-0 convs as a GEMM (the k1conv variant)
    use_k1conv: bool = True
    use_iconv: bool = True
    # a strided conv with k > 1 as a space-to-depth fold + the stride-1
    # direct conv (ops/kernels/conv.py:space_to_depth_conv)
    use_s2d: bool = False
    # the stem (stride > 1, kernel > 1, C*s*s <= 64) as a stride-1 conv on its
    # space-to-depth fold (graph/lowering_nhwc.py:_stem_s2d_conv); pad_c pads
    # the folded channels; stem_im2col picks boda_tpu's emitter for it
    stem_s2d: int = 0
    stem_im2col: int = 0
    pad_c: int = 0
    # halo-conv variants of boda_tpu's Pallas conv
    tap_cat: bool = False
    nb: int = 0
    use_halo: int = -1
    # int8 conv/fc compute: per-tensor act and per-out-channel weight scales,
    # an int32 accumulator (cuBLASLt's int8 GEMM), a float epilogue
    int8: bool = False
    # pooling emitter variants of boda_tpu's XLA pool
    pool_shift: int = 0
    pool_bview: int = 0
    # pooling on the hand pooling kernel (ops/kernels/pool.py) instead of
    # the library pool
    pool_pallas: int = 0
    # DetectionOutput NMS candidate count (0: the prototxt's top_k)
    det_top_k: int = 0
    # accumulate and compute dtype overrides (boda_tpu declares them and no
    # kernel of it reads them)
    acc_tn: str = "float32"
    in_tn: str = ""
    # 'highest' = full f32; bf16 compute always runs 'default' (bf16 inputs,
    # f32 accumulate)
    precision: str = "highest"
    # escape hatch: the library op (cuDNN/cuBLAS via F.conv2d/torch.matmul)
    # instead of a hand kernel, the analog of boda_tpu's XLA path
    use_xla: bool = False
    # Mosaic's last-grid-dim semantics
    dimension_semantics: str = "arbitrary"

    def no_effect(self) -> list[str]:
        """The knobs set away from their defaults that do nothing on the card."""
        return [n for n in NO_EFFECT if getattr(self, n) != _DEFAULTS[n]]

    def effective(self) -> "OpTune":
        """This tune with the knobs that do nothing on the card at their
        defaults: two tunes with the same effective tune run the same."""
        return replace(self, **{n: _DEFAULTS[n] for n in NO_EFFECT})

    def key(self) -> str:
        parts = []
        for f in fields(self):
            v = getattr(self, f.name)
            if v != f.default:
                parts.append(f"{f.name}={Lexp(leaf_val=str(int(v) if isinstance(v, bool) else v))}")
        return "(" + ",".join(parts) + ")"

    def __str__(self) -> str:
        return self.key()

    @staticmethod
    def parse(s: str) -> "OpTune":
        return OpTune.from_lexp(parse_lexp(s))

    @staticmethod
    def from_lexp(l: Lexp) -> "OpTune":
        if l.is_leaf and not l.leaf_val:
            return OpTune()
        l.deep_inc_use_cnt()
        kw = {}
        ftypes = {f.name: f.type for f in fields(OpTune)}
        for k, v in l.kids:
            if k not in ftypes:
                raise ValueError(f"op_tune: unknown knob {k!r}; have {sorted(ftypes)}")
            t = ftypes[k]
            if t == "bool":
                kw[k] = v.leaf_val in ("1", "true", "True")
            elif t == "int":
                kw[k] = int(v.leaf_val)
            else:
                kw[k] = v.leaf_val
        return OpTune(**kw)


_DEFAULTS = {f.name: f.default for f in fields(OpTune)}

# variants of boda_tpu's Pallas/XLA lowerings with the same result
NO_EFFECT = ("bm", "bn", "bk", "chunk", "use_iconv", "stem_im2col", "tap_cat", "nb",
             "use_halo", "pool_shift", "pool_bview", "acc_tn", "in_tn",
             "dimension_semantics")
