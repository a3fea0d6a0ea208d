"""The work plans of the float conv kernels K1 and B2.

K1 (``csrc/conv.cu`` on the persistent mainloop of ``csrc/conv_ring.cuh``)
and B2 (``csrc/conv_dw.cu``) take their plan from here as a few integers;
each kernel derives the same indices from them, and lays out its shared
memory as :func:`ring_smem` and :func:`b2_smem` do. Everything depends on
the shape, the element size and the card's SM count, never on timing.

**K1** (:func:`k1_plan`):

- **Tiles** of ``RING_TILE`` = 256 output pixels: ``imgs`` images of
  ``th`` x ``tw`` pixels each (``tw`` in 32, 16, 8; ``imgs`` in 1, 2, 4, 8;
  ``th = 256 / (tw * imgs)``, at least one warp's 32 pixels an image), so
  that GEMM rows run over B*H*W: an 8 x 8 map fills a tile with four
  images. The tile that leaves the fewest tiles, the smaller halo on a
  tie, then the wider, among those whose shared memory fits. Tile ``t``
  is images from ``(t // (tiles_y * tiles_x)) * imgs``, row of tiles
  ``ty``, column ``tx`` in row-major order.
- **Channel groups** of ``co`` output channels (8, 16 or 32; 8 where
  Cout <= 8). Item ``i`` is tile ``i % tiles`` of group ``i // tiles``.
- **Passes** of 32 input channels (``RING_CCH``), each padded to the
  MMA's k, the taps in order within a pass: the one-process mainloop's sum
  order, so that y is bitwise the parent tree's where K is not split.
- **The card.** The group is the one with the least estimated time
  (:func:`_k1_cost`): the busiest SM's items (the items over the SMs)
  times an item's passes times the shared-memory reads of a pass, which
  grow with the group. Only at serving's deep shapes (one image, 256
  input channels or more, ``DEEP_PASSES``) whose items no group makes
  fill the card (1 x 12 x 15, 1 x 24 x 30) is K split, if that costs less
  and the units fit in one round, over at most 2 blocks where a block
  takes an SM (float32): the ``slices`` blocks of a thread-block cluster
  take passes ``[q * passes // slices, (q + 1) * passes // slices)`` and
  the first adds the others' float32 sums in rank order, bitwise
  repeatable but not the parent's order (:attr:`K1Plan.bitwise`). Every
  other shape keeps the one-process sum order: training's (a model
  axis's shard then computes its channels bitwise as the whole layer
  does, and an update follows the previous K1's trajectory), a small
  batch's maps, the shallow heads.
- **The ring.** Resident weights (the group's rows of every pass of the
  block) before streamed ones (each stage carries its pass's rows), the
  deepest ring (float32 2 stages, bfloat16 4) that fits; first within
  half an SM's shared memory where the kernel runs two blocks a SM
  (bfloat16, and float32 at k 1).
- **The persistent walk.** The kernel launches ``n`` clusters, the items
  or as many as the card holds at once if fewer, and cluster ``c`` takes
  the consecutive items ``[c * items // n, (c + 1) * items // n)``.
- **The one-image tile** (:func:`_tile_wins`, ``ns`` 0): where x's pixel
  rows are not whole 16-byte rows, which TMA cannot stage, and at the 1 x
  1 heads of up to 64 input channels, the plan keeps the one-process
  mainloop (``csrc/conv_tile.cuh``): one block per 8 x 32 tile of one
  image and 32 output channels (8 where Cout <= 8), each pass staged by
  ``cp.async``, then multiplied; same sum order, same bits.

**B2** (:func:`b2_plan`):

- **Pixel tiles** of ``B2_PIX`` = 128 pixels that span images in the same
  way (``tw * imgs <= 128``, ``th = 128 / (tw * imgs)``): the fewest, the
  wider on a tie. Wherever one image's tile is among the fewest this is
  the one-image tile of the parent tree's B2 (32 wide past 16 columns,
  16 past 8), so its pixels are summed in the same order there; the 8 x
  8 maps take two images.
- **Output tiles** of K*K*32 rows (8 input channels at k 5) by 32 output
  channels (8 where Cout <= 8); **chunks** of consecutive pixel tiles where
  the output tiles leave SMs idle, as many as keep the items within one
  round of two blocks a SM; an
  **item** is one output tile over one chunk, ``i % out_tiles`` over chunk
  ``i // out_tiles``. A second launch adds the chunks in a fixed order.
- **The ring** of ``ns`` staging buffers (2 to 4, the deepest within two
  blocks a SM), running across a block's consecutive items; the epilogue's
  tile in a buffer just read where it fits there.
"""

import functools
from typing import NamedTuple

__all__ = ["RING_TILE", "RING_CCH", "RING_MAX_SMEM", "RING_HALF_SMEM",
           "RING_MAX_SLICES", "B2_PIX", "K1Plan", "B2Plan", "k1_plan",
           "b2_plan", "ring_smem", "tile_smem", "b2_smem"]

RING_TILE = 256           # output pixels per tile: 8 warps x 32 pixels
RING_CCH = 32             # input channels per pass
RING_ALIGN = 1024         # a TMA swizzle pattern's span
RING_NS = 4               # ring stages, at most (float32: 2)
RING_MAX_SMEM = 232448    # dynamic shared memory of one block
RING_HALF_SMEM = 115712   # of each of two blocks on one SM
RING_MAX_SLICES = 4       # blocks of a cluster splitting K
DEEP_PASSES = 8           # passes (256 input channels) of a deep shape
_NT, _MT = 256, 2         # threads of a block, m16 tiles of a warp
K1_WIDTHS = (32, 16, 8)
K1_IMGS = (1, 2, 4, 8)

B2_PIX = 128              # pixels per tile
B2_NS = 4                 # staging buffers, at most
B2_WIDTHS = (32, 16, 8)
B2_IMGS = (1, 2, 4, 8, 16)
_B2_MW, _B2_MAX_WARPS = 3, 8


def _ceil(a, b):
    return -(-a // b)


def _align(n, a):
    return _ceil(n, a) * a


def _wstride(co):
    """Elements between bfloat16 weight rows of a group of co
    (conv_tile.cuh::wstride), or between g pixels of B2's tile."""
    return 8 if co == 8 else co + 8


class K1Plan(NamedTuple):
    b: int
    h: int
    w: int
    cin: int
    cout: int
    k: int
    tw: int           # tile width
    th: int           # tile rows an image
    imgs: int         # images a tile
    tiles_x: int
    tiles_y: int
    tiles_b: int      # tiles along the images
    co: int           # output channels a group
    groups: int
    passes: int       # passes of 32 input channels
    slices: int       # blocks a cluster, splitting an item's passes
    ns: int           # ring stages; 0: the one-image tile, no ring
    resident: bool    # the group's weights stay in shared memory
    smem: int         # dynamic shared memory of a block

    @property
    def ring(self):
        """Whether the plan runs on the persistent ring (else on the
        one-process mainloop's one-image tile, one block an item)."""
        return self.ns > 0

    @property
    def tiles(self):
        return self.tiles_b * self.tiles_y * self.tiles_x

    @property
    def items(self):
        return self.tiles * self.groups

    @property
    def bitwise(self):
        """Whether each output's sum runs in the one-process order."""
        return self.slices == 1

    def item(self, i):
        """(b0, y0, x0, co0) of item ``i``: its tile's first image and
        origin and its group's first channel."""
        g, t = divmod(i, self.tiles)
        bt, r = divmod(t, self.tiles_y * self.tiles_x)
        ty, tx = divmod(r, self.tiles_x)
        return bt * self.imgs, ty * self.th, tx * self.tw, g * self.co

    def cluster_items(self, c, n):
        """The items of cluster ``c`` of ``n``."""
        return range(c * self.items // n, (c + 1) * self.items // n)

    def block_passes(self, q):
        """The passes of block ``q`` of a cluster."""
        return range(q * self.passes // self.slices,
                     (q + 1) * self.passes // self.slices)

    def pass_channels(self, p):
        """Input channels [c0, c1) of pass ``p`` and its padded count."""
        c0 = p * RING_CCH
        c1 = min(self.cin, c0 + RING_CCH)
        return c0, c1, _align(c1 - c0, 8)


def ring_smem(k, co, esize, tw, imgs, passes, slices, resident, ns):
    """Dynamic shared memory of K1's block (conv_ring.cuh::layout): the
    mbarriers, ns stages of the halo tile (and the pass's weight rows
    where they are streamed), float32's work area of split hi and lo
    planes, the resident weights of the block's passes, the cluster's sum
    area."""
    th = RING_TILE // (tw * imgs)
    f32 = esize == 4
    np_max = _ceil(passes, slices)
    halo = _align(imgs * (th + k - 1) * (tw + k - 1) * RING_CCH * esize,
                  RING_ALIGN)
    w_bytes = k * k * RING_CCH * (co if f32 else _wstride(co)) * esize
    raw_w = _align(w_bytes, RING_ALIGN)
    off = RING_ALIGN + ns * (halo + (0 if resident else raw_w))
    if f32:
        off += 2 * halo + (0 if resident else 2 * raw_w)
    if resident:
        off += _align(np_max * w_bytes * (2 if f32 else 1), RING_ALIGN)
    if slices > 1:
        off += _NT * _MT * (co // 8) * 4 * 4
    return off


def tile_smem(k, co, esize, cin):
    """Dynamic shared memory of the one-image tile's block
    (conv_tile.cuh::smem_bytes): the halo tile of 8 + k - 1 rows of 32 + k
    - 1 pixels of the first pass's channels, padded to 8 (float32 pixel
    stride + 4, bfloat16 | 8), and the pass's weight rows."""
    cpad = _align(min(cin, RING_CCH), 8)
    cs = cpad + 4 if esize == 4 else cpad | 8
    return esize * ((8 + k - 1) * (32 + k - 1) * cs
                    + k * k * cpad * _wstride(co))


def _tile_wins(cin, k, esize):
    """Where K1 stays on the one-image tile: x's pixel rows not whole
    16-byte rows (TMA cannot stage them, and the ring's thread copies ran
    1.2-1.9x the tile's time at the decoders' 130, 258 and 514 channels),
    and the 1 x 1 heads of up to 64 input channels (one or two passes an
    item, behind the ring's fixed costs: 1.05-1.7x the tile's time); H100,
    PERF.md."""
    return (cin * esize) % 16 != 0 or (k == 1 and cin <= 2 * RING_CCH)


def _ring_fit(k, co, esize, tw, imgs, passes, slices, budget, steps=None):
    """(resident, ns, bytes) of the first layout within budget: resident
    weights before streamed ones, the deepest ring first, no deeper than
    the ``steps`` a block takes where given; None if none."""
    ns_max = 2 if esize == 4 else RING_NS
    if steps is not None:
        ns_max = max(1, min(ns_max, steps))
    for resident in (True, False):
        for ns in range(ns_max, 0, -1):
            smem = ring_smem(k, co, esize, tw, imgs, passes, slices,
                             resident, ns)
            if smem <= budget:
                return resident, ns, smem
    return None


def _tiles(b, h, w, tw, th, imgs):
    return _ceil(b, imgs) * _ceil(h, th) * _ceil(w, tw)


def _k1_tiles(b, h, w, k):
    """K1's tile shapes (tw, th, imgs), the fewest tiles first, then the
    smaller halo, then the wider."""
    shapes = []
    for tw in K1_WIDTHS:
        for imgs in K1_IMGS:
            th = RING_TILE // (tw * imgs)
            if th * tw >= 32 and (imgs == 1 or imgs <= b):
                halo = imgs * (th + k - 1) * (tw + k - 1)
                shapes.append((_tiles(b, h, w, tw, th, imgs), halo, -tw,
                               imgs, tw, th))
    return [(tw, th, imgs) for *_, imgs, tw, th in sorted(shapes)]


def _k1_cost(co, esize, units, sms, passes_per_block):
    """Estimated time of the busiest SM, in shared-memory reads of a k
    step of a warp: its work units (the units spread over the SMs, two
    blocks on one SM sharing its throughput) x a unit's passes x the reads
    of one step (A's fragments, and B's, which grow with the group:
    float32 16 wavefronts of A's hi and lo planes and 4 a n8 tile;
    bfloat16 8 and 2)."""
    a, b = (16, 4) if esize == 4 else (8, 2)
    return _ceil(units, sms) * passes_per_block * (a + b * co // 8)


@functools.lru_cache(maxsize=1024)
def k1_plan(b, h, w, cin, cout, k, esize, sms):
    """The plan of K1 on x [b, h, w, cin] into ``cout`` channels at kernel
    size ``k`` for elements of ``esize`` bytes (4 float32, 2 bfloat16) on
    a card with ``sms`` SMs."""
    passes = _ceil(cin, RING_CCH)
    if _tile_wins(cin, k, esize):
        co = 8 if cout <= 8 else 32
        return K1Plan(b, h, w, cin, cout, k, 32, 8, 1, _ceil(w, 32),
                      _ceil(h, 8), b, co, _ceil(cout, co), passes, 1, 0,
                      False, tile_smem(k, co, esize, cin))
    cos = (8,) if cout <= 8 else (32, 16, 8)
    # (budget, blocks a SM): first within half an SM where the kernel runs
    # two blocks a SM (bfloat16, and float32 at k 1: conv.cu's bounds)
    budgets = ((RING_HALF_SMEM, 2), (RING_MAX_SMEM, 1)) if (
        esize == 2 or k == 1) else ((RING_MAX_SMEM, 1),)
    for tw, th, imgs in _k1_tiles(b, h, w, k):
        tiles = _tiles(b, h, w, tw, th, imgs)
        for budget, per_sm in budgets:
            cap = sms * per_sm
            # (cost, co, slices, fit): the least cost, the wider group on
            # a tie; K split only at serving's deep single-image shapes
            # whose items no group makes fill the card, over at most 2
            # blocks where a block fills an SM (a cluster of more is not
            # held at once), in one round
            best, most = None, 0
            for co in cos:
                fit = _ring_fit(k, co, esize, tw, imgs, passes, 1, budget)
                if fit is None:
                    continue
                items = tiles * _ceil(cout, co)
                most = max(most, items)
                cost = _k1_cost(co, esize, items, sms, passes)
                if best is None or cost < best[0]:
                    best = (cost, co, 1, fit)
            if best is None:
                continue
            if b == 1 and passes >= DEEP_PASSES and most < cap:
                for co in cos:
                    items = tiles * _ceil(cout, co)
                    for slices in range(2, min(RING_MAX_SLICES, passes,
                                               2 * per_sm) + 1):
                        fit = _ring_fit(k, co, esize, tw, imgs, passes,
                                        slices, budget)
                        if fit is None or items * slices > cap:
                            continue
                        cost = _k1_cost(co, esize, items * slices, sms,
                                        _ceil(passes, slices))
                        if cost < best[0]:
                            best = (cost, co, slices, fit)
            _, co, slices, fit = best
            # no deeper a ring than the steps of the busiest block
            units = tiles * _ceil(cout, co) * slices
            steps = _ceil(units, cap) * _ceil(passes, slices)
            resident, ns, smem = _ring_fit(k, co, esize, tw, imgs, passes,
                                           slices, budget, steps) or fit
            return K1Plan(b, h, w, cin, cout, k, tw, th, imgs, _ceil(w, tw),
                          _ceil(h, th), _ceil(b, imgs), co, _ceil(cout, co),
                          passes, slices, ns, resident, smem)
    raise ValueError(f"conv2d_same: no K1 plan fits x {(b, h, w, cin)}, "
                     f"Cout {cout}, k {k}")


class B2Plan(NamedTuple):
    b: int
    h: int
    w: int
    cin: int
    cout: int
    k: int
    tw: int           # pixel tile width
    th: int           # pixel tile rows an image
    imgs: int         # images a pixel tile
    tiles_x: int
    tiles_y: int
    tiles_b: int
    cb: int           # input channels an output tile
    bn: int           # output channels an output tile
    cblocks: int
    coblocks: int
    per_chunk: int    # pixel tiles a chunk
    chunks: int
    ns: int           # staging buffers
    threads: int      # 32 x warps along the rows x warps along the pixels
    smem: int

    @property
    def ntiles(self):
        return self.tiles_b * self.tiles_y * self.tiles_x

    @property
    def out_tiles(self):
        return self.cblocks * self.coblocks

    @property
    def items(self):
        return self.chunks * self.out_tiles

    def item(self, i):
        """(c0, co0, pixel tiles) of item ``i``: its output tile's first
        input and output channels and its chunk's pixel tiles."""
        chunk, o = divmod(i, self.out_tiles)
        cbi, cob = divmod(o, self.coblocks)
        t0 = chunk * self.per_chunk
        return (cbi * self.cb, cob * self.bn,
                range(t0, min(self.ntiles, t0 + self.per_chunk)))

    def tile(self, t):
        """(b0, y0, x0) of pixel tile ``t``."""
        bt, r = divmod(t, self.tiles_y * self.tiles_x)
        ty, tx = divmod(r, self.tiles_x)
        return bt * self.imgs, ty * self.th, tx * self.tw

    def block_items(self, blk, n):
        """The items of block ``blk`` of ``n``."""
        return range(blk * self.items // n, (blk + 1) * self.items // n)


def _b2_halo_stride(cb, esize):
    """conv_dw.cu::halo_stride: the halo's pixel stride in elements."""
    cs = _align(cb, 8)
    if esize == 2:
        return cs | 8
    return cs + 8 if cs % 32 in (0, 16) else cs


def b2_smem(k, cin, cout, esize, tw, imgs, ns):
    """Dynamic shared memory of B2's block (conv_dw.cu::make_geo): the
    ring's mbarriers, ns staging buffers of the halo tile and the g tile
    (each from a 128-byte boundary), and the epilogue's float32 output
    tile where it does not fit in one of them."""
    th = B2_PIX // (tw * imgs)
    cb = min(8 if k == 5 else 32, cin)
    bn = 8 if cout <= 8 else 32
    halo = imgs * (th + k - 1) * (tw + k - 1) * _b2_halo_stride(cb, esize)
    stage = _align(_align(esize * halo, 128) + esize * B2_PIX * _wstride(bn),
                   128)
    out = 4 * bn * ((k * k * cb) | 1)
    return 128 + ns * stage + (0 if out <= stage else out)


@functools.lru_cache(maxsize=1024)
def b2_plan(b, h, w, cin, cout, k, esize, sms):
    """The plan of B2 on x [b, h, w, cin] and g [b, h, w, cout] at kernel
    size ``k`` for elements of ``esize`` bytes on a card with ``sms``
    SMs."""
    shapes = []
    for tw in B2_WIDTHS:
        for imgs in B2_IMGS:
            if tw * imgs <= B2_PIX and (imgs == 1 or imgs <= b):
                th = B2_PIX // (tw * imgs)
                halo = imgs * (th + k - 1) * (tw + k - 1)
                shapes.append((_tiles(b, h, w, tw, th, imgs), -tw, halo,
                               imgs, tw, th))
    ntiles, _, _, imgs, tw, th = min(shapes)
    cb_max = 8 if k == 5 else 32
    bn = 8 if cout <= 8 else 32
    cblocks, coblocks = _ceil(cin, cb_max), _ceil(cout, bn)
    out_tiles = cblocks * coblocks
    # split the pixels only where the output tiles leave SMs idle: then
    # into as many chunks as keep the items within one round of two blocks
    # a SM (a few items past it made the round two: the decoders' 258 and
    # 514 channels ran 1.2-1.6x the parent's time at 270 and 272 items)
    chunks = 1 if out_tiles >= sms else min(ntiles, max(
        1, 2 * sms // out_tiles))
    per_chunk = _ceil(ntiles, chunks)
    chunks = _ceil(ntiles, per_chunk)
    ns = next((n for n in range(B2_NS, 1, -1)
               if b2_smem(k, cin, cout, esize, tw, imgs, n)
               <= RING_HALF_SMEM), 2)
    smem = b2_smem(k, cin, cout, esize, tw, imgs, ns)
    if smem > RING_MAX_SMEM:
        raise ValueError(f"conv2d_dw: no B2 plan fits x {(b, h, w, cin)}, "
                         f"Cout {cout}, k {k}")
    rows = k * k * (_align(min(cb_max, cin), 8) if esize == 2
                    else min(cb_max, cin))
    wm = _ceil(_ceil(rows, 16), _B2_MW)
    threads = 32 * wm * max(1, _B2_MAX_WARPS // wm)
    return B2Plan(b, h, w, cin, cout, k, tw, th, imgs, _ceil(w, tw),
                  _ceil(h, th), _ceil(b, imgs), cb_max, bn, cblocks, coblocks,
                  per_chunk, chunks, ns, threads, smem)
