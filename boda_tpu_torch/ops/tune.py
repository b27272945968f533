"""The tuning knobs of the generated-kernel path.

Counterpart of ``boda_tpu/ops/tune.py`` ``OpTune``, cut to the knobs the
ResNet forward reads, with the same names, defaults and ``key()`` format,
so a tune string written for ``boda_tpu`` parses here when it only names
these knobs (an unknown knob is an error, as there): the blocking knobs,
``use_k1conv``, ``use_s2d`` (the strided conv on the space-to-depth fold),
``pool_pallas`` (the pooling kernel), ``precision`` and ``use_xla``. The
other knobs (stem_s2d, halo, tap_cat, nb, int8, the other pooling
variants, ...) are not ported.

``bm``/``bn``/``bk``/``chunk`` are accepted and kept in the key, but the
port's hand kernels have compile-time tiles (``csrc/gemm.cuh``), so nothing
reads them yet; ``precision`` only decides the f32 path (both kernels run
full f32 there) and is logged.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

from ..utils.lexp import Lexp


@dataclass(frozen=True)
class OpTune:
    # blocking knobs of boda_tpu's Pallas kernels (see the module doc)
    bm: int = 256
    bn: int = 256
    bk: int = 512
    chunk: int = 0
    # 1x1 pad-0 convs as a GEMM (the k1conv variant)
    use_k1conv: bool = True
    # a strided conv with k > 1 as a space-to-depth fold + the stride-1
    # direct conv (ops/kernels/conv.py:space_to_depth_conv)
    use_s2d: bool = False
    # pooling on the hand pooling kernel (ops/kernels/pool.py) instead of
    # the library pool
    pool_pallas: int = 0
    # 'highest' = full f32; bf16 compute always runs 'default' (bf16 inputs,
    # f32 accumulate)
    precision: str = "highest"
    # escape hatch: the library op (cuDNN/cuBLAS via F.conv2d/torch.matmul)
    # instead of a hand kernel, the analog of boda_tpu's XLA path
    use_xla: bool = False

    def key(self) -> str:
        parts = []
        for f in fields(self):
            v = getattr(self, f.name)
            if v != f.default:
                parts.append(f"{f.name}={Lexp(leaf_val=str(int(v) if isinstance(v, bool) else v))}")
        return "(" + ",".join(parts) + ")"

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
