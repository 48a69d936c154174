"""Minimum Hamming distance sweep over genome shifts (`uhamming`).

Counterpart of biokanga_tpu/tools/uhamming.py `_sweep_block` (:33) and
`_cross_sweep` (:116), the tool's whole device work.  For genome codes g
(n,) and valid (n,) (the K-window at a locus lies inside one entry):

- the watson sweep over shifts d in [lo, hi): each valid pair of windows
  (i, i+d) with i+d+K <= n lowers hmin at both loci to their Hamming
  distance, saturated at 255;
- with `include_rc`, the cross sweep: each valid window of g against
  every valid window of h = revcomp(g), shifts d in [-(n-K), n-K].

A code >= 4 mismatches everything, another N too.  The result is uint8,
255 (`H_INVALID`) where no pair counted.

On a CUDA tensor `uhamming_sweep` launches csrc/uhamming_sweep.cu once a
sweep (see the source note there) or raises; on a CPU tensor it runs
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
                        sym: bool) -> None:
    """Fold the shifts [lo, hi) of a-windows against b-windows into hmin32
    ((n,) int32), in blocks of shifts: mismatch rows, windowed sums by
    cumsum, masks, a min over the block (and a scatter-min at i+d for the
    watson sweep's symmetric update)."""
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
        w8 = torch.where(ok, w.clamp(max=H_INVALID), H_INVALID)
        hmin32[:n_win] = torch.minimum(hmin32[:n_win], w8.amin(0))
        if sym:
            # locus i+d receives the pair's value; masked pairs go to n
            tgt = torch.where(ok, ui, n).reshape(-1)
            ext = torch.cat([hmin32, hmin32.new_full((1,), H_INVALID)])
            ext.scatter_reduce_(0, tgt, w8.reshape(-1), "amin")
            hmin32.copy_(ext[:n])


def uhamming_sweep_plain(g: torch.Tensor, valid: torch.Tensor,
                         hmin: torch.Tensor, K: int, lo: int, hi: int,
                         include_rc: bool) -> torch.Tensor:
    h32 = hmin.to(torch.int32)
    _sweep_shifts_plain(g, g, valid, valid, h32, K, lo, hi, sym=True)
    if include_rc:
        n = g.shape[0]
        _sweep_shifts_plain(g, _revcomp(g), valid, _rc_valid(valid, K), h32,
                            K, -(n - K), n - K + 1, sym=False)
    return h32.to(torch.uint8)


def _kernel_codes(g: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """uint8 code (0-3, anything else 4) | valid << 7."""
    c = torch.where((g >= 0) & (g < 4), g, 4).to(torch.uint8)
    return c | (valid.to(torch.uint8) << 7)


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
    a = _kernel_codes(g, valid).contiguous()
    h32 = hmin.to(torch.int32).contiguous()
    sweeps = [(a, lo, hi, 1)]
    if include_rc:
        b = _kernel_codes(_revcomp(g), _rc_valid(valid, K)).contiguous()
        sweeps.append((b, -(n - K), n - K + 1, 0))
    lib = kernels.library()
    stream = kernels.stream_ptr(g.device)
    with torch.cuda.device(g.device):
        for b, d_lo, d_hi, sym in sweeps:
            if n - K + 1 <= 0 or d_hi <= d_lo:
                continue
            err = lib.uhamming_sweep(a.data_ptr(), b.data_ptr(),
                                     h32.data_ptr(), n, K, d_lo, d_hi, sym,
                                     stream)
            kernels.check(err, "uhamming_sweep")
            uhamming_sweep.launches += 1
    return h32.to(torch.uint8)


uhamming_sweep.launches = 0
