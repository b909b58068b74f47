"""Chained bf16 product with a stationary right operand: the CUDA kernel
``csrc/matmul_stationary.cu`` and its plain PyTorch version.

Replaces the Pallas TPU probe ``tools/probe_pallas.py:matmul_stationary``:
``reps`` times ``a <- bf16(a @ w)``, accumulated in f32 and rounded to
bf16 (nearest even) after each rep, returned as f32. The kernel takes the
probe's k = n = 128 and m a multiple of 16.

The tensor core sums a rep's products in its own order, so kernel and
plain version can differ by one bf16 ulp where a sum rounds near a tie;
``bf16_ulps`` measures that difference.

``matmul_stationary`` launches the kernel for CUDA tensors and runs
``matmul_stationary_plain`` only for CPU tensors; there is no fallback
from one to the other. The kernel reads its operands from 16-byte
aligned addresses: an operand that starts elsewhere (a view at an odd
offset) is copied to a fresh tensor first.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

DIM = 128   # k == n of the kernel (the probe's shape)


def matmul_stationary_plain(a: torch.Tensor, w: torch.Tensor,
                            reps: int) -> torch.Tensor:
    """The kernel's function in torch ops: an f32 product of the bf16
    values (each bf16 product is exact in f32) rounded to bf16 per rep."""
    x, wf = a, w.float()
    for _ in range(reps):
        x = torch.matmul(x.float(), wf).to(torch.bfloat16)
    return x.float()


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in units of the bf16 ulp at ``want`` (8 significant
    bits; the smallest normal's ulp for zero and denormals)."""
    want = want.float()
    _, exp = torch.frexp(want.abs().clamp(min=torch.finfo(torch.float32).tiny))
    return (got.float() - want).abs() / torch.ldexp(torch.ones_like(want),
                                                    exp - 8)


def _check(a, w, reps):
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"matmul_stationary: a and w must be bfloat16, got "
                        f"{a.dtype} and {w.dtype}")
    if a.dim() != 2 or tuple(w.shape) != (DIM, DIM) or a.shape[1] != DIM \
            or a.shape[0] % 16:
        raise ValueError(f"matmul_stationary: the kernel takes a [m, {DIM}] "
                         f"with m % 16 == 0 and w [{DIM}, {DIM}]; got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if w.device != a.device:
        raise ValueError(f"matmul_stationary: w is on {w.device}, a on "
                         f"{a.device}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_stationary: a and w must be contiguous")
    if reps < 0:
        raise ValueError(f"matmul_stationary: reps={reps} < 0")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy of it at a 16-byte aligned address."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _library():
    lib = cuda_build.load("matmul_stationary")
    fn = lib.hs_matmul_stationary
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def matmul_stationary(a: torch.Tensor, w: torch.Tensor,
                      reps: int) -> torch.Tensor:
    """f32[m, n]: ``a`` (bf16[m, k]) after ``reps`` chained products with
    ``w`` (bf16[k, n], k == n), each rounded to bf16. CPU tensors take the
    plain version; CUDA tensors launch the kernel (on the current stream)
    or raise."""
    if a.device.type == "cpu":
        return matmul_stationary_plain(a, w, reps)
    _check(a, w, reps)
    a, w = _aligned(a), _aligned(w)
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = _library()(a.data_ptr(), w.data_ptr(), out.data_ptr(),
                        a.shape[0], int(reps),
                        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"matmul_stationary: kernel launch failed with "
                           f"CUDA error {rc}")
    matmul_stationary.launches += 1
    return out


matmul_stationary.launches = 0   # kernel launches, for chip_smoke.py
