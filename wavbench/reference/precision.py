"""The precisions the reference computes its products in.

``exact`` leaves every operand of a product in float32 (TF32 off, see
``model.float32_matmul``). ``fp8`` is the control: the step below the
configuration's bfloat16, as fp8 training takes it, with each operand of
every product (convolutions, projections, the attention's two products)
rounded to float8 e4m3 under a per-tensor scale that maps its largest
magnitude to the format's largest, and each gradient flowing back into an
operand rounded to float8 e5m2 under the same rule.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round_scaled(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_scaled(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_scaled(g, torch.float8_e5m2, E5M2_MAX)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


PRECISIONS = {"exact": exact, "fp8": fp8}
