"""Plain models of two CUDA kernels' orders, held to the plain versions
on the CPU.

The fusion forward kernel (`dcf_torch/csrc/fusion_fwd.cu`) splits each
pixel's candidates over L lanes (lane l takes bin slots c = l, l + L,
...), keeps a K-list per lane, and merges the lanes' lists with a
butterfly of bitonic merges (the elementwise minimum of one list and the
other reversed, then sorted) by the key (d2, candidate index), where the
candidate index is the slot's index in the tile's halo: ((ti + di) *
(TW + 2r) + tj + dj) * C + c. The KNN kernel (`dcf_torch/csrc/knn.cu`)
selects the same way with its own tiles and 1 to 32 lanes, splitting by
window cell and slot: lane l takes the candidates w * C + c = l (mod L),
w = di * (2r + 1) + dj. `_lane_split_select` repeats either with
tensors; it must equal `knn_select_plain` (the first-minimum argmin in
scan order) bit for bit, ties included, for one lane and for every lane
count and tile each kernel uses.

The bf16 micro-benchmark kernel (`dcf_torch/csrc/int8_mma.cu`) sums each
output element in one float32 accumulator over all 128 products, in the
order (k, 128-byte chunk, product, 16-deep step). `_bf16_kernel_order`
repeats that in float32; its error against the float64 plain version
must stay within `selection_mma_tolerance` and, on dense operands, be
nonzero (the bound is tested, not vacuous).

The rotated clip kernel (`dcf_torch/csrc/clip.cu`) clips the live
vertices only: per edge of b, each list entry emits its edge crossing
and itself where valid, appended in list order; a `split` flag records
that the first edge of some stage emitted no crossing, and the shoelace
sum then starts with the closing term. `_compacting_clip` repeats that
with the plain version's operations; it must equal
`rotated_intersection_area` (the doubling, filled buffers) bit for bit
on random, hard, near-identical, nested, disjoint, touching and lattice
pairs, and its lists must stay within the kernel's 6 / 9 / 13 / 19
slots.

The fusion backward kernel (`dcf_torch/csrc/fusion_bwd.cu`) fills a
bucket of pair indices per point (integer atomics, in any order), sorts
each bucket, and sums d_z1 per point in pair order; d_wgt / d_bg sum per
warp over its points, then by a fixed tree per block, then over the
blocks per lane and by a butterfly (the kernel fuses d_wgt's products
into its sums, which this model does not). `_bucket_bwd` repeats that
(with the buckets filled in a scrambled order): d_z1 must equal
`fused_fusion_bwd_plain`'s on the CPU bit for bit (`index_add_` adds in
pair order), and d_wgt / d_bg must be within `fusion_bwd_tolerance`,
also where one point is selected by more pairs than a bucket holds.
"""

import numpy as np
import pytest
import torch

import dcf_torch.ops.fusion as tfus
import dcf_torch.ops.int8_mma as M
import dcf_torch.ops.knn as tknn
from chip_smoke import CLIP_HARD
from dcf_torch.geometry.boxes import (_cross2, box_corners_bev,
                                      rotated_intersection_area)
from dcf_torch.ops.fusion import FWD_TILES, fusion_launch_shape
from dcf_torch.ops.knn import KNN_TILES, knn_launch_shape, knn_smem_bytes

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


def _lane_split_select(bins, k, r, lanes, tiles=FWD_TILES, by_cell=False):
    """A kernel's selection: per-lane K-lists keyed by (d2, halo index),
    merged by a butterfly over the lanes; lane l takes the slots c = l
    (mod lanes) of every window cell, or with `by_cell` the candidates
    w * C + c = l (mod lanes) (the KNN kernel's split). Returns (nbr,
    valid, dist2) as `knn_select_plain` does."""
    data, valid = bins
    B, Hh, Ww, C, D = data.shape
    th, tw = tiles.get(lanes, (16, 16))   # one lane: the plain scan
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
    # per lane: its candidates, then its K-list
    w = torch.arange(win * win)[:, None]
    q = w * C + c if by_cell else c.expand(win * win, C)     # [9, C]
    lists = []
    for lane in range(lanes):
        sel = q % lanes == lane
        ld = d2[..., sel]
        ls = key[..., sel]
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


# every K and r = 0..2, bin capacities C that are and are not multiples
# of the lane count, random points and the quarter-cell lattice's ties
KNN_SPLIT_CASES = [(False, 1, 0, 8), (True, 2, 1, 8), (False, 3, 2, 5),
                   (True, 4, 1, 4), (True, 5, 0, 32), (False, 6, 1, 8),
                   (True, 7, 2, 8), (True, 8, 2, 5)]


@pytest.mark.parametrize("lanes", list(KNN_TILES))
@pytest.mark.parametrize("lattice,k,r,cap", KNN_SPLIT_CASES)
def test_knn_lane_split_selection_matches_plain(lanes, lattice, k, r, cap):
    """The KNN kernel's split by (window cell, slot) at every lane count
    its rule can pick, bit-equal to the plain version."""
    bins = _bins(lanes + 10 * k, lattice, cap=cap)
    want_nbr, want_ok, want_d2 = tknn.knn_select_plain(bins, (0.0, 0.0),
                                                       1.0, k, r)
    nbr, ok, d2 = _lane_split_select(bins, k, r, lanes, KNN_TILES,
                                     by_cell=True)
    assert torch.equal(ok, want_ok) and torch.equal(d2, want_d2)
    assert torch.equal(nbr[ok], want_nbr[want_ok])
    if lattice and k > 1:   # the ties that the key has to order
        assert int(((d2[..., 1:] == d2[..., :-1]) & ok[..., 1:]).sum()) > 0


@pytest.mark.parametrize("B,H,W,lanes", [
    (1, 352, 400, 2), (1, 176, 200, 2), (1, 88, 100, 4), (1, 44, 50, 8),
    (2, 352, 400, 2), (2, 176, 200, 2), (2, 88, 100, 2), (2, 44, 50, 8),
    (1, 7, 9, 8)])
def test_knn_launch_shape(B, H, W, lanes):
    """The KNN kernel's launch shape at the main path's four scales (C = 8,
    D = 4, K = 4, r = 1; B = 1 and 2) on a 132-SM card: 256 threads per
    block, the fewest lanes whose grid has a block per SM, else 8."""
    got = knn_launch_shape(B, H, W, 8, 4, 4, 1, 132)
    assert got[0] == lanes and got[0] * got[1] * got[2] == 256
    assert got[2] & (got[2] - 1) == 0
    assert B * -(-H // got[1]) * -(-W // got[2]) >= 132 or lanes == 8


def test_knn_launch_shape_shared_memory():
    """Where a shape's tiles do not fit in shared memory the rule takes a
    smaller one; at the kernel's limits (C 32, D 16, K 8, r 3) the
    smallest tile fits, one step beyond (r 4) none does."""
    assert knn_smem_bytes(8, 16, 8, 4, 4, 1) <= tknn.SMEM_BYTES
    assert knn_launch_shape(1, 352, 400, 32, 16, 8, 3, 132) == (16, 4, 4)
    assert knn_launch_shape(1, 44, 50, 32, 16, 8, 2, 132) == (8, 4, 8)
    assert knn_smem_bytes(2, 4, tknn.MAX_SLOTS, tknn.MAX_COLS,
                          tknn.MAX_NEIGHBORS,
                          tknn.MAX_RADIUS) <= tknn.SMEM_BYTES
    with pytest.raises(ValueError):
        knn_launch_shape(1, 44, 50, 32, 16, 8, 4, 132)


def test_knn_plain_takes_any_shape():
    """On CPU tensors `knn_select_dense` is the plain version, beyond the
    kernel's limits too (C = 40, D = 17, k = 9, r = 4)."""
    rng = np.random.default_rng(3)
    pts = np.zeros((1, 300, 17), np.float32)
    pts[..., :2] = rng.uniform(0, 9, (1, 300, 2))
    bins = tknn.bin_points_dense(torch.from_numpy(pts),
                                 torch.ones((1, 300), dtype=torch.bool),
                                 (0.0, 0.0), 1.0, (9, 9), 40)
    got = tknn.knn_select_dense(bins, (0.0, 0.0), 1.0, 9, 4)
    want = tknn.knn_select_plain(bins, (0.0, 0.0), 1.0, 9, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].shape == (1, 9, 9, 9, 17) and bool(got[1].all())


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


CLIP_SLOTS = (6, 9, 13, 19)    # the kernel's list sizes after each stage


def _compacting_clip(a, b, sizes=None):
    """The clip kernel's order: per edge of b, each entry of the live list
    emits its crossing (with the previous entry) and itself where valid,
    appended in order; `split` is set when a stage's first entry emits no
    crossing. Areas of [N, 5] pairs; `sizes` collects each stage's
    largest list."""
    poly, cb = box_corners_bev(a), box_corners_bev(b)
    N = poly.shape[0]
    n = torch.full((N,), 4)
    split = torch.zeros(N, dtype=torch.bool)
    for k in range(4):
        p1, p2 = cb[:, None, k], cb[:, None, (k + 1) % 4]
        slot = torch.arange(poly.shape[1])
        d = _cross2(p1, p2, poly)
        pi = torch.where(slot == 0, n[:, None] - 1, slot - 1).clamp(min=0)
        prev = torch.gather(poly, 1, pi[..., None].expand(-1, -1, 2))
        d_prev = torch.gather(d, 1, pi)
        cur_in = d >= 0.0
        denom = d_prev - d
        t = d_prev / torch.where(denom.abs() < 1e-12, 1e-12, denom)
        inter = prev + t[..., None] * (poly - prev)
        cand = torch.stack([inter, poly], 2).flatten(1, 2)
        valid = (torch.stack([cur_in != (d_prev >= 0.0), cur_in], 2)
                 & (slot < n[:, None])[..., None]).flatten(1)
        split = split | ~valid[:, 0]
        n = valid.sum(1)
        pos = torch.where(valid, torch.cumsum(valid, 1) - 1, cand.shape[1])
        out = torch.zeros(N, cand.shape[1] + 1, 2)
        out.scatter_(1, pos[..., None].expand(-1, -1, 2), cand)
        poly = out[:, :max(int(n.max()), 1)]
        if sizes is not None:
            sizes.append(int(n.max()))
    slot = torch.arange(poly.shape[1])
    nxt = torch.gather(poly, 1, torch.where(slot + 1 < n[:, None], slot + 1,
                                            0)[..., None].expand(-1, -1, 2))
    term = poly[..., 0] * nxt[..., 1] - poly[..., 1] * nxt[..., 0]
    closing = torch.gather(term, 1, (n - 1).clamp(min=0)[:, None])[:, 0]
    acc = torch.where(split, closing, 0.0)
    for i in range(poly.shape[1] - 1):
        acc = torch.where(i < n - 1, acc + term[:, i], acc)
    acc = torch.where(split, acc, acc + closing)
    return torch.where(n > 0, 0.5 * acc.abs(), 0.0)


def _clip_case(name, n=4000):
    """[n, 5] x [n, 5] box pairs of one kind."""
    rng = np.random.default_rng(sorted(CLIP_CASES).index(name))

    def boxes(spread, center=(0.0, 0.0)):
        b = np.zeros((n, 5), np.float32)
        b[:, :2] = rng.uniform(-spread, spread, (n, 2)) + np.array(center)
        b[:, 2:4] = rng.uniform(0.3, 5.0, (n, 2))
        b[:, 4] = rng.uniform(-np.pi, np.pi, n)
        return b

    def lattice():
        return np.stack([rng.integers(-2, 3, n) * 0.5,
                         rng.integers(-2, 3, n) * 0.5,
                         rng.integers(0, 5, n) * 0.5,
                         rng.integers(0, 5, n) * 0.5,
                         rng.integers(0, 8, n) * np.pi / 4], 1)
    if name == "random":
        a, b = boxes(4.0, (30.0, 0.0)), boxes(4.0, (30.0, 0.0))
    elif name == "dense":
        a, b = boxes(1.0), boxes(1.0)
    elif name == "near_identical":        # touching, nearly equal boxes
        a = boxes(2.0)
        b = a + rng.normal(size=a.shape) * [1e-6, 1e-6, 1e-6, 1e-6, 1e-7] \
            * (rng.uniform(size=(n, 1)) < 0.7)
    elif name == "nested":                # b well inside a, and a in b
        a = boxes(2.0)
        b = a.copy()
        b[:, 2:4] *= rng.uniform(0.1, 0.9, (n, 2))
        b[:, 4] += rng.uniform(-0.2, 0.2, n)
        b[n // 2:], a[n // 2:] = a[n // 2:].copy(), b[n // 2:].copy()
    elif name == "disjoint":
        a = boxes(2.0)
        b = boxes(2.0, (20.0, -20.0))
    else:                                 # shared edges and corners
        a, b = lattice(), lattice()
    return (torch.from_numpy(np.asarray(a, np.float32)),
            torch.from_numpy(np.asarray(b, np.float32)))


CLIP_CASES = ("random", "dense", "near_identical", "nested", "disjoint",
              "lattice")


@pytest.mark.parametrize("name", CLIP_CASES + ("hard",))
def test_compacting_clip_matches_plain(name):
    """Bit for bit: 6 x 4,000 seeded pairs plus CLIP_HARD."""
    if name == "hard":
        a = torch.from_numpy(CLIP_HARD[:, 0].copy())
        b = torch.from_numpy(CLIP_HARD[:, 1].copy())
    else:
        a, b = _clip_case(name)
    sizes = []
    got = _compacting_clip(a, b, sizes)
    want = rotated_intersection_area(a, b)
    assert torch.equal(got, want), int((got != want).sum())
    assert all(s <= c for s, c in zip(sizes, CLIP_SLOTS)), sizes
    if name == "disjoint":
        assert not got.any()
    if name in ("random", "dense", "nested"):
        assert (got > 0).float().mean() > 0.2


def _bwd_case(seed, lattice=False, B=2, H=13, W=21, P=600, cap=8, k=4,
              hid=16, r=1):
    """A stash of `fused_fusion_plain` (odd grid) and a cotangent view."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((B, P, 4), np.float32)
    if lattice:
        pts[..., 0] = rng.integers(0, 4 * H, (B, P)) / 4 + 0.125
        pts[..., 1] = rng.integers(0, 4 * W, (B, P)) / 4 + 0.125
    else:
        pts[..., 0] = rng.uniform(-1, H + 1, (B, P))
        pts[..., 1] = rng.uniform(-1, W + 1, (B, P))
    pts[..., 2] = rng.uniform(-2, 2, (B, P))
    pts[..., 3] = np.arange(P)
    mask = rng.uniform(size=(B, P)) < 0.9
    bins = tknn.bin_points_dense(torch.from_numpy(pts),
                                 torch.from_numpy(mask), (0.0, 0.0), 1.0,
                                 (H, W), cap)
    data = tfus.quantize_payload_xyz(bins.data, (0.0, 0.0), 1.0)

    def t(x):
        return torch.from_numpy(x.astype(np.float32))
    z1 = t(rng.normal(size=(B, P, hid)))
    wgt = t(rng.normal(size=(hid, 4)) * 0.3)
    bg = t(rng.normal(size=hid) * 0.1)
    _, stash = tfus.fused_fusion_plain(data, bins.valid, z1, wgt, bg,
                                       (0.0, 0.0), 1.0, k, r, stash=True)
    dacc = t(rng.normal(size=(B, H, W, hid + 1)))[..., :hid]
    return stash, z1, wgt, bg, dacc


def _bucket_bwd(stash, z1, wgt, bg, dacc, blocks=3, warps=32, seed=0):
    """The backward kernel's order: buckets filled in a scrambled order,
    each sorted by pair index (a point with more than BWD_BUCKET pairs is
    scanned in pair order: the same order); d_z1 summed per point in pair
    order; d_wgt / d_bg summed per warp (point gw + i * blocks * warps,
    pairs in order), by the block's tree, then per lane over the blocks
    and by a butterfly."""
    B, P, hid = z1.shape
    rows, g, dpre = tfus._live_pairs(stash, z1, wgt, bg, dacc)
    M = rows.numel()
    fill = torch.randperm(M, generator=torch.Generator().manual_seed(seed))
    order = fill[torch.argsort(rows[fill] * (M + 1) + fill)]   # (key, pair)
    cnt = torch.bincount(rows, minlength=B * P)
    start = torch.cumsum(cnt, 0) - cnt
    acc = torch.zeros(B * P, hid)
    for t in range(int(cnt.max())):
        has = cnt > t
        acc[has] = acc[has] + dpre[order[start[has] + t]]
    # d_wgt / d_bg: [hid, 5] partials per warp
    terms = torch.cat([dpre[..., None] * g[:, None, :], dpre[..., None]], -1)
    tw = blocks * warps
    part = torch.zeros(tw, hid, 5)
    for i in range(-(-B * P // tw)):
        keys = torch.arange(tw) + i * tw
        keys = torch.where(keys < B * P, keys, 0)
        n = torch.where(torch.arange(tw) + i * tw < B * P, cnt[keys], 0)
        for t in range(int(n.max())):
            has = n > t
            part[has] = part[has] + terms[order[start[keys[has]] + t]]
    red = part.reshape(blocks, warps, hid, 5)
    red = red[:, :warps // 2] + red[:, warps // 2:]
    s = warps // 4
    while s >= 1:
        red = red[:, :s] + red[:, s:2 * s]
        s //= 2
    lanes = torch.zeros(32, hid, 5)
    for blk in range(blocks):
        lanes[blk % 32] = lanes[blk % 32] + red[blk, 0]
    m = 16
    while m >= 1:
        lanes = lanes + lanes[torch.arange(32) ^ m]
        m //= 2
    return acc.reshape(B, P, hid), lanes[0, :, :4].contiguous(), lanes[0, :, 4]


# the last two dense: one point selected by all 9 (r = 1) or 25 (r = 2)
# pixels that can select it
@pytest.mark.parametrize("lattice,k,r,hid,P,most", [
    (False, 4, 1, 16, 600, 7), (True, 8, 2, 48, 600, 8),
    (False, 1, 1, 16, 600, 3), (True, 4, 1, 64, 150, 9),
    (False, 8, 2, 16, 60, 25)])
def test_bucket_bwd_matches_plain(lattice, k, r, hid, P, most):
    args = _bwd_case(k + hid + P, lattice, k=k, hid=hid, P=P, r=r)
    want = tfus.fused_fusion_bwd_plain(*args)
    tols = tfus.fusion_bwd_tolerance(*args)
    got = _bucket_bwd(*args)
    assert torch.equal(got[0], want[0])
    for a, b, tol in zip(got[1:], want[1:], tols[1:]):
        assert bool(((a - b).abs() <= tol).all())
    sel = args[0][0]
    per_point = torch.bincount((torch.arange(2)[:, None, None, None] * P
                                + sel.long())[sel >= 0])
    assert int(per_point.max()) == most


def test_bucket_bwd_overfull_point():
    """A stash where a few points are selected by far more pixels than a
    bucket holds (every pixel picks from 3 points): d_z1 still equals the
    plain version's bit for bit (pair order), d_wgt / d_bg within bound."""
    stash, z1, wgt, bg, dacc = _bwd_case(3, k=2)
    sel, geo = stash
    sel = torch.where(sel >= 0, sel % 3, sel)
    args = ((sel, geo), z1, wgt, bg, dacc)
    assert int(torch.bincount(sel[0][sel[0] >= 0].long()).max()) \
        > tfus.BWD_BUCKET
    want = tfus.fused_fusion_bwd_plain(*args)
    tols = tfus.fusion_bwd_tolerance(*args)
    got = _bucket_bwd(*args)
    assert torch.equal(got[0], want[0])
    for a, b, tol in zip(got[1:], want[1:], tols[1:]):
        assert bool(((a - b).abs() <= tol).all())
