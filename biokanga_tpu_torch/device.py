"""Device choice and the 32-bit unsigned helpers the plain paths share.

The device is always named by the caller.  `resolve_device("cuda")`
raises when PyTorch sees no CUDA device: nothing in this package moves
work to the CPU on its own.

Unsigned 32-bit words: the JAX package packs bases into uint32 words
and compares keys as unsigned.  PyTorch on the CPU has no `>>`, `<<`,
`>`, `searchsorted` or popcount for uint32, so the plain paths hold each
word as a non-negative int64 (`u32`), mask every left shift with
`U32_MASK`, and count bits with SWAR (`popcount32`).  Tensors that a
CUDA kernel reads keep the same 32 bits in int32 storage (`i32_bits`);
the kernels read them as `uint32_t`.

Suffix keys are held in 32 bits (`key32`): the unsigned word with its
sign bit flipped, as int32, so that a signed compare of two keys is the
unsigned compare of their words.
"""
from __future__ import annotations

import numpy as np
import torch

U32_MASK = 0xFFFFFFFF
I32_MAX = 2**31 - 1
SIGN32 = 2**31


def resolve_device(arg: str | torch.device) -> torch.device:
    """torch.device(arg); raises if it is a CUDA device and CUDA is absent."""
    dev = torch.device(arg)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False"
        )
    return dev


def u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor holding 32-bit words -> int64 with the unsigned value."""
    return x.to(torch.int64) & U32_MASK


def i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def key32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2^32) -> int32 keys in the same
    order: each value with its sign bit flipped (x - 2^31)."""
    return (x - SIGN32).to(torch.int32)


def key32_from_numpy(a: np.ndarray) -> np.ndarray:
    """numpy uint32 array -> int32 keys in the same order (`key32`)."""
    a = np.asarray(a, np.uint32) ^ np.uint32(SIGN32)
    return a.view(np.int32)


def u32_from_key32(k: torch.Tensor) -> torch.Tensor:
    """`key32` keys -> int64 with the unsigned word's value."""
    return k.to(torch.int64) + SIGN32


def u32_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor with the same bits on `device`."""
    a = np.require(a, np.uint32, ["C", "W"])
    return torch.from_numpy(a.view(np.int32)).to(device)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int64 value in [0, 2^32) (SWAR, no popcount op)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32_MASK) >> 24
