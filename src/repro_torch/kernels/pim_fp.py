"""Bit-serial IEEE-754 float32 multiply: the port of the reference's K8
kernel entry (``repro/kernels/pim_fp.py``).

``pim_fp32_mul`` replaces the Pallas TPU kernel ``_pim_fp32_mul_kernel``
with a CUDA kernel for Hopper written by hand (``csrc/pim_fp.cu``): the
paper's Fig. 4b mantissa shift-and-add, 24 steps into two 24-bit limbs,
round to nearest even. Subnormal inputs read as signed zeros and
subnormal results flush to signed zeros (DAZ/FTZ), the reference's
contract under XLA; the kernel source states its bound and design.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version ``ref.pim_fp32_mul_ref`` — the analogue
of the reference's interpret mode. ``launches`` counts the kernel's
launches.

Forward only, as the reference gives the kernel no VJP: an input that
requires grad (with grad enabled) raises, so no result silently lacks a
gradient.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# csrc pim_fp32_mul(a, b, out, n, stream)
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_void_p)


def pim_fp32_mul(a: torch.Tensor, b: torch.Tensor, *,
                 block: int = 1024) -> torch.Tensor:
    """Elementwise float32 ``a * b`` through the PIM shift-and-add: same
    shape in and out, float32 only.

    ``block`` is kept for signature parity with the reference, whose
    Pallas grid tiles the flattened inputs in rows of ``block``; it has no
    effect on the result or on the launch (the kernel masks its own
    tail).
    """
    del block
    if a.shape != b.shape:
        raise ValueError(f"pim_fp32_mul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"pim_fp32_mul: dtypes {a.dtype}/{b.dtype}, want "
                        f"float32")
    if a.device != b.device:
        raise ValueError(f"pim_fp32_mul: operands on {a.device} and "
                         f"{b.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise ValueError("pim_fp32_mul is forward only (the reference "
                         "kernel has no VJP): call it on tensors that do "
                         "not require grad, or under torch.no_grad()")
    if a.device.type == "cpu":
        return ref.pim_fp32_mul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pim_fp32_mul runs on cuda or cpu tensors, got "
                         f"{a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("pim_fp32_mul: operands must be contiguous")
    out = torch.empty_like(a)
    if not a.numel():
        return out
    kernel = build.load("pim_fp32_mul", _ARGTYPES, source="pim_fp")
    with torch.cuda.device(a.device):
        rc = kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                    torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pim_fp32_mul kernel launch failed (cudaError "
                           f"{rc})")
    pim_fp32_mul.launches += 1
    return out


pim_fp32_mul.launches = 0
