#!/usr/bin/env python3
"""Why the rtc ``conv`` op's library tune rounds once (CPU, no card needed).

cuDNN's bf16 conv, as ``F.conv2d`` calls it, rounds its f32 sums to bf16 and
ATen then adds the bias, a second rounding; boda_tpu's XLA conv
(``preferred_element_type=float32``) and the port's hand kernels add the
bias in f32 and round once. This script computes both on ops_prof's
``gen_data`` inputs for a few ResNet-50 conv shapes at batch 1 (one f32
conv on the CPU gives the sums both share) and counts the elements that
ops_prof's cross-tune check (``comp_vars(mrd_toler=1e-2,
atol=1e-4 * max|kg|)``) would flag between the two.

    python3 scripts/torch_bias_rounding.py
"""

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from boda_tpu_torch.ops.kernels.gen_data import gen_data_pattern  # noqa: E402
from boda_tpu_torch.utils.digest import comp_vars  # noqa: E402

# (C, H, OC, k, stride, pad): ResNet-50 convs at batch 1
SHAPES = [(3, 224, 64, 7, 2, 3), (64, 56, 64, 3, 1, 1), (64, 56, 256, 1, 1, 0),
          (256, 56, 64, 1, 1, 0), (512, 7, 2048, 1, 1, 0)]


def main() -> None:
    bf16 = torch.bfloat16
    for c, h, oc, k, s, p in SHAPES:
        # ops_prof's gen_data seeds for the in, filts and biases args
        x = gen_data_pattern((1, c, h, h), "bfloat16", mod=13, stride=7).float()
        w = gen_data_pattern((oc, c, k, k), "bfloat16", mod=17, stride=11).float()
        b = gen_data_pattern((oc,), "bfloat16", mod=19, stride=5).float().view(1, -1, 1, 1)
        acc = F.conv2d(x, w, stride=s, padding=p)
        once = (acc + b).to(bf16).float().numpy()
        twice = (acc.to(bf16).float() + b).to(bf16).float().numpy()
        r = comp_vars(twice, once, mrd_toler=1e-2,
                      atol=1e-4 * float(np.abs(twice).max()))
        print(f"conv C={c} {h}x{h} -> {oc}, k{k} s{s} p{p}: {r.num_diff} of {r.n} "
              f"elements flagged (mad {r.mad:.3g}, max|out| {np.abs(twice).max():.3g})")


if __name__ == "__main__":
    main()
