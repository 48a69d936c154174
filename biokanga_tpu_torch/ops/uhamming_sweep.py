"""Minimum Hamming distance sweep over genome shifts (`uhamming`).

Counterpart of biokanga_tpu/tools/uhamming.py `_sweep_block` (:33) and
`_cross_sweep` (:116), the tool's whole device work.  For genome codes g
(n,) and valid (n,) (the K-window at a locus lies inside one entry):

- the watson sweep over shifts d in [lo, hi): each valid pair of windows
  (i, i+d) with i+d+K <= n lowers hmin at both loci to their Hamming
  distance, saturated at 255;
- with `include_rc`, the cross sweep: each valid window of g against
  every valid window of h = revcomp(g), shifts d in [-(n-K), n-K].  The
  window at i against h's at j = i+d is g_i against rc(g_k), k = n-K-j,
  and Ham(g_i, rc g_k) = Ham(g_k, rc g_i) is the same diagonal's pair
  (k, i): each unordered pair is evaluated once (i <= k) and lowers hmin
  at i and at k.

A code >= 4 mismatches everything, another N too.  The result is uint8,
255 (`H_INVALID`) where no pair counted.

On a CUDA tensor `uhamming_sweep` packs g (and h) into bit planes
(`pack_planes`) and launches csrc/uhamming_sweep.cu once a sweep (see the
source note there) or raises; on a CPU tensor it runs
`uhamming_sweep_plain`, a loop over blocks of shifts in torch ops.
"""
from __future__ import annotations

import torch

from .. import kernels

H_INVALID = 255
# elements of one (shifts x loci) block of the plain version
_PLAIN_BLOCK_ELEMS = 1 << 24


def _check(g: torch.Tensor, valid: torch.Tensor, hmin: torch.Tensor) -> None:
    n = g.shape[0]
    if g.dim() != 1 or g.dtype != torch.int8:
        raise ValueError(f"uhamming_sweep: want (n,) int8 codes, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError("uhamming_sweep: want (n,) bool valid")
    if hmin.shape != (n,) or hmin.dtype != torch.uint8:
        raise ValueError("uhamming_sweep: want (n,) uint8 hmin")
    if not (g.device == valid.device == hmin.device):
        raise ValueError("uhamming_sweep: tensors on different devices")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"uhamming_sweep: unsupported device {g.device}")


def _revcomp(g: torch.Tensor) -> torch.Tensor:
    r = g.flip(0)
    return torch.where(r >= 4, r, 3 - r)


def _rc_valid(valid: torch.Tensor, K: int) -> torch.Tensor:
    """valid_rc[j] = valid[n-j-K] for j <= n-K, else False."""
    n = valid.shape[0]
    out = torch.zeros_like(valid)
    if n - K + 1 > 0:
        out[: n - K + 1] = valid[: n - K + 1].flip(0)
    return out


def _sweep_shifts_plain(a, b, va, vb, hmin32, K: int, lo: int, hi: int,
                        cross: bool) -> None:
    """Fold the shifts [lo, hi) of a-windows against b-windows into hmin32
    ((n,) int32), in blocks of shifts: mismatch rows, windowed sums by
    cumsum, masks, a min over the block at i and a scatter-min at the
    pair's other locus (i+d for the watson sweep; k = n-K-d-i for the
    cross sweep, whose pairs count once, i <= k)."""
    n = a.shape[0]
    n_win = n - K + 1
    if n_win <= 0 or hi <= lo:
        return
    dev = a.device
    a16, b16 = a.to(torch.int16), b.to(torch.int16)
    t = torch.arange(n, device=dev)
    i = t[:n_win]
    D = max(1, min(hi - lo, _PLAIN_BLOCK_ELEMS // n))
    for d0 in range(lo, hi, D):
        d = torch.arange(d0, min(d0 + D, hi), device=dev)[:, None]
        u = t + d                                          # (D, n)
        inb = (u >= 0) & (u < n)
        bu = b16[u.clamp(0, n - 1)]
        m = ~inb | (a16 != bu) | (a16 >= 4) | (bu >= 4)
        c = torch.nn.functional.pad(m.cumsum(1, dtype=torch.int32), (1, 0))
        w = c[:, K:K + n_win] - c[:, :n_win]               # (D, n_win)
        ui = i + d
        ok = (va[:n_win] & (ui >= 0) & (ui + K <= n)
              & vb[ui.clamp(0, n - 1)])
        other = ui
        if cross:
            other = n - K - ui
            ok &= i <= other
        w8 = torch.where(ok, w.clamp(max=H_INVALID), H_INVALID)
        hmin32[:n_win] = torch.minimum(hmin32[:n_win], w8.amin(0))
        # the other locus receives the pair's value; masked pairs go to n
        tgt = torch.where(ok, other, n).reshape(-1)
        ext = torch.cat([hmin32, hmin32.new_full((1,), H_INVALID)])
        ext.scatter_reduce_(0, tgt, w8.reshape(-1), "amin")
        hmin32.copy_(ext[:n])


def uhamming_sweep_plain(g: torch.Tensor, valid: torch.Tensor,
                         hmin: torch.Tensor, K: int, lo: int, hi: int,
                         include_rc: bool) -> torch.Tensor:
    h32 = hmin.to(torch.int32)
    _sweep_shifts_plain(g, g, valid, valid, h32, K, lo, hi, cross=False)
    if include_rc:
        n = g.shape[0]
        _sweep_shifts_plain(g, _revcomp(g), valid, _rc_valid(valid, K), h32,
                            K, -(n - K), n - K + 1, cross=True)
    return h32.to(torch.uint8)


def plane_pad(K: int) -> int:
    """Positions of padding before and after the genome in the planes:
    at least K + 64 and a whole number of words (the kernel reads at most
    96 positions before and 127 past the genome)."""
    return 32 * ((K + 64 + 31) // 32) + 128


def pack_planes(codes: torch.Tensor, valid: torch.Tensor,
                pad: int) -> torch.Tensor:
    """(4, W) int32 bit planes of (n,) codes: the low code bit, the high
    code bit, N (a code outside 0-3) and valid; position p is bit 31 - q %
    32 of word q // 32, q = pad + p, and the pad + n + pad positions
    (rounded up to a word) read N outside [0, n)."""
    n = codes.shape[0]
    W = (2 * pad + n + 31) // 32
    dev = codes.device
    bits = torch.zeros((4, W * 32), dtype=torch.uint8, device=dev)
    bits[2] = 1
    is_n = (codes < 0) | (codes >= 4)
    c = torch.where(is_n, 0, codes).to(torch.uint8)
    bits[0, pad:pad + n] = c & 1
    bits[1, pad:pad + n] = c >> 1
    bits[2, pad:pad + n] = is_n.to(torch.uint8)
    bits[3, pad:pad + n] = valid.to(torch.uint8)
    byte_w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                          device=dev)
    by = (bits.view(4, W * 4, 8) * byte_w).sum(-1, dtype=torch.int64)
    word_w = torch.tensor([1 << 24, 1 << 16, 1 << 8, 1], dtype=torch.int64,
                          device=dev)
    w = (by.view(4, W, 4) * word_w).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def uhamming_sweep(g: torch.Tensor, valid: torch.Tensor, hmin: torch.Tensor,
                   K: int, lo: int, hi: int,
                   include_rc: bool = True) -> torch.Tensor:
    """hmin lowered by the watson sweep over shifts [lo, hi) and, with
    include_rc, the cross sweep against the reverse complement.  Returns
    a new (n,) uint8 tensor."""
    _check(g, valid, hmin)
    if g.device.type == "cpu":
        return uhamming_sweep_plain(g, valid, hmin, K, lo, hi, include_rc)
    n = g.shape[0]
    h32 = hmin.to(torch.int32).contiguous()
    sweeps = [(lo, hi, 0)]
    if include_rc:
        sweeps.append((-(n - K), n - K + 1, 1))
    sweeps = [s for s in sweeps if n - K + 1 > 0 and s[1] > s[0]]
    if not sweeps:
        return h32.to(torch.uint8)
    pad = plane_pad(K)
    a = pack_planes(g, valid, pad)
    lib = kernels.library()
    stream = kernels.stream_ptr(g.device)
    with torch.cuda.device(g.device):
        for d_lo, d_hi, cross in sweeps:
            b = pack_planes(_revcomp(g), _rc_valid(valid, K), pad) \
                if cross else a
            err = lib.uhamming_sweep(a.data_ptr(), b.data_ptr(), a.shape[1],
                                     pad, h32.data_ptr(), n, K, d_lo, d_hi,
                                     cross, stream)
            kernels.check(err, "uhamming_sweep")
            uhamming_sweep.launches += 1
    return h32.to(torch.uint8)


uhamming_sweep.launches = 0
