"""Plain models of two CUDA kernels' orders, held to the plain versions
on the CPU.

The fusion forward kernel (`dcf_torch/csrc/fusion_fwd.cu`) splits each
pixel's candidates over L lanes (lane l takes bin slots c = l, l + L,
...), keeps a K-list per lane, and merges the lanes' lists with a
butterfly of bitonic merges (the elementwise minimum of one list and the
other reversed, then sorted) by the key (d2, candidate index), where the
candidate index is the slot's index in the tile's halo: ((ti + di) *
(TW + 2r) + tj + dj) * C + c. `_lane_split_select` repeats that with tensors; it must equal
`knn_select_plain` (the first-minimum argmin in scan order) bit for bit,
ties included, for one lane and for every lane count and tile the kernel
uses.

The bf16 micro-benchmark kernel (`dcf_torch/csrc/int8_mma.cu`) sums each
output element in one float32 accumulator over all 128 products, in the
order (k, 128-byte chunk, product, 16-deep step). `_bf16_kernel_order`
repeats that in float32; its error against the float64 plain version
must stay within `selection_mma_tolerance` and, on dense operands, be
nonzero (the bound is tested, not vacuous).
"""

import numpy as np
import pytest
import torch

import dcf_torch.ops.int8_mma as M
import dcf_torch.ops.knn as tknn
from dcf_torch.ops.fusion import FWD_TILES, fusion_launch_shape

torch.set_num_threads(1)

H, W = 13, 21          # not a multiple of any tile


def _bins(seed, lattice, B=2, P=700, cap=8):
    """Dense bins of P points over an H x W grid of 1 m cells; with
    `lattice`, x / y on a quarter-cell lattice (many equal distances)."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((B, P, 4), np.float32)
    if lattice:
        pts[..., 0] = rng.integers(-4, 4 * H + 4, (B, P)) / 4 + 0.125
        pts[..., 1] = rng.integers(-4, 4 * W + 4, (B, P)) / 4 + 0.125
    else:
        pts[..., 0] = rng.uniform(-1, H + 1, (B, P))
        pts[..., 1] = rng.uniform(-1, W + 1, (B, P))
    pts[..., 2] = rng.uniform(-2, 2, (B, P))
    pts[..., 3] = np.arange(P)
    mask = rng.uniform(size=(B, P)) < 0.9
    return tknn.bin_points_dense(torch.from_numpy(pts),
                                 torch.from_numpy(mask), (0.0, 0.0), 1.0,
                                 (H, W), cap)


def _lex_topk(d, s, k):
    """The k smallest (d, s) pairs along the last dim, lexicographically."""
    o = torch.argsort(s, dim=-1, stable=True)
    d, s = torch.gather(d, -1, o), torch.gather(s, -1, o)
    o = torch.argsort(d, dim=-1, stable=True)[..., :k]
    return torch.gather(d, -1, o), torch.gather(s, -1, o)


def _bitonic_merge(a, b):
    """The kernel's merge of two key-sorted K-lists: c[k] = min(a[k],
    b[K-1-k]) by key, then sorted (the kernel's transposition network)."""
    (ad, as_), (bd, bs) = a, (b[0].flip(-1), b[1].flip(-1))
    take = (bd < ad) | ((bd == ad) & (bs < as_))
    return _lex_topk(torch.where(take, bd, ad), torch.where(take, bs, as_),
                     ad.shape[-1])


def _lane_split_select(bins, k, r, lanes):
    """The fusion kernel's selection: per-lane K-lists keyed by (d2, halo
    index), merged by a butterfly over the lanes. Returns (nbr, valid,
    dist2) as `knn_select_plain` does."""
    data, valid = bins
    B, Hh, Ww, C, D = data.shape
    th, tw = FWD_TILES.get(lanes, (16, 16))   # one lane: the plain scan
    win = 2 * r + 1
    pdata = torch.nn.functional.pad(data, (0, 0, 0, 0, r, r, r, r))
    pvalid = torch.nn.functional.pad(valid.to(torch.uint8),
                                     (0, 0, r, r, r, r)).bool()
    cx, cy = tknn.cell_centers(Hh, Ww, (0.0, 0.0), 1.0, "cpu")
    ti = (torch.arange(Hh) % th)[:, None, None]              # [H, 1, 1]
    tj = (torch.arange(Ww) % tw)[None, :, None]              # [1, W, 1]
    c = torch.arange(C)
    d2s, keys, cands = [], [], []
    for di in range(win):
        for dj in range(win):
            sd = pdata[:, di:di + Hh, dj:dj + Ww]
            sv = pvalid[:, di:di + Hh, dj:dj + Ww]
            ddx = sd[..., 0] - cx[..., None]
            ddy = sd[..., 1] - cy[..., None]
            d = ddx * ddx + ddy * ddy
            d2s.append(torch.where(sv & (d < 1e30), d, torch.inf))
            keys.append((((ti + di) * (tw + 2 * r) + tj + dj) * C + c)
                        .expand(B, Hh, Ww, C))
            cands.append(sd)
    d2 = torch.stack(d2s, -2)                                # [B,H,W,9,C]
    key = torch.stack(keys, -2)
    cand = torch.cat(cands, -2)                              # [B,H,W,9C,D]
    # per lane: slots c = lane (mod lanes), then its K-list
    lists = []
    for lane in range(lanes):
        sel = c % lanes == lane
        ld = d2[..., sel].flatten(-2)
        ls = key[..., sel].flatten(-2)
        pad = max(0, k - ld.shape[-1])
        ld = torch.nn.functional.pad(ld, (0, pad), value=torch.inf)
        ls = torch.nn.functional.pad(ls, (0, pad), value=2 ** 40)
        lists.append(_lex_topk(ld, ls, k))
    off = 1
    while off < lanes:
        lists = [_bitonic_merge(lists[l], lists[l ^ off])
                 for l in range(lanes)]
        off *= 2
    for d, s in lists[1:]:                   # every lane holds the result
        assert torch.equal(d, lists[0][0]) and torch.equal(s, lists[0][1])
    d, s = lists[0]
    ok = d < 1e30
    # halo index -> candidate row in scan order (di, dj, c)
    hw = tw + 2 * r
    cell, cc = s.clamp(max=2 ** 30) // C, s.clamp(max=2 ** 30) % C
    di, dj = cell // hw - ti, cell % hw - tj
    row = torch.where(ok, (di * win + dj) * C + cc, 0)
    nbr = torch.gather(cand, -2, row[..., None].expand(*row.shape, D))
    return nbr, ok, d


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("lattice,k,r", [(False, 4, 1), (True, 8, 2)])
def test_lane_split_selection_matches_plain(lanes, lattice, k, r):
    bins = _bins(lanes + 10 * k, lattice)
    want_nbr, want_ok, want_d2 = tknn.knn_select_plain(bins, (0.0, 0.0),
                                                       1.0, k, r)
    nbr, ok, d2 = _lane_split_select(bins, k, r, lanes)
    assert torch.equal(ok, want_ok) and torch.equal(d2, want_d2)
    assert torch.equal(nbr[ok], want_nbr[want_ok])
    if lattice:   # the ties that the key has to order
        ties = (d2[..., 1:] == d2[..., :-1]) & ok[..., 1:]
        assert int(ties.sum()) > 100


def _bf16_kernel_order(slab, oh):
    """The bf16 kernel's float32 sum: for k, for each 64-element chunk,
    for the 32 products that share oh[k], for each 16-deep step, add the
    step's dot into one float32 accumulator."""
    acc = torch.zeros((M.HID, M.W), dtype=torch.float32)
    ohf = oh.to(torch.float32)
    scaled = {i: M.scaled_slab(slab, i).to(torch.float32)
              for i in range(1, M.PRODUCTS + 1)}
    for k in range(M.K):
        for c0 in range(0, M.CAPR, 64):
            for t in range(M.REPS * M.TH):
                s = scaled[1 + t * M.K + k]
                for d0 in range(c0, c0 + 64, 16):
                    acc += s[:, d0:d0 + 16] @ ohf[k, d0:d0 + 16]
    return acc


@pytest.mark.parametrize("density", [1 / M.CAPR, 0.05])
def test_bf16_kernel_order_within_tolerance(density):
    rng = np.random.default_rng(7)
    slab = torch.from_numpy((rng.normal(size=(M.HID, M.CAPR)) * 8).astype(
        np.float32)).to(torch.bfloat16)
    oh = torch.from_numpy((rng.uniform(size=(M.K, M.CAPR, M.W)) < density)
                          .astype(np.float32)).to(torch.bfloat16)
    got = _bf16_kernel_order(slab, oh).to(torch.float64)
    want = M.selection_mma_plain(slab, oh)
    tol = M.selection_mma_tolerance(slab, oh)
    err = (got - want).abs()
    assert bool((err <= tol).all()), float((err / tol.clamp(min=1e-30)).max())
    if density > 0.01:
        assert float(err.max()) > 0


@pytest.mark.parametrize("B,H,W,lanes", [
    (1, 352, 400, 2), (1, 176, 200, 2), (1, 88, 100, 8), (1, 44, 50, 8),
    (2, 88, 100, 4), (2, 44, 50, 8), (1, 7, 9, 8)])
def test_fusion_launch_shape(B, H, W, lanes):
    """The forward kernel's launch shape at the main path's four scales
    (B = 1 serving, B = 2 training) on a 132-SM card: 256 threads per
    block, the fewest lanes that still give two blocks per SM."""
    got = fusion_launch_shape(B, H, W, 132)
    assert got[0] == lanes and got[0] * got[1] * got[2] == 256
    assert got[2] & (got[2] - 1) == 0
