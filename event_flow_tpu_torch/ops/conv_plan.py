"""The work plans of the float conv kernels K1, K2 and B2.

K1 (``csrc/conv.cu``) and K2 (``csrc/fused_lif.cu``), both on the
persistent mainloop of ``csrc/conv_ring.cuh``, and B2
(``csrc/conv_dw.cu``) take their plan from here as a few integers;
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
  order, so that y is bitwise the one-process K1's where K is not split
  (float32 everywhere; bfloat16 off the wgmma route below).
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
  repeatable but not the parent's order (:attr:`ConvPlan.bitwise`). Every
  other shape off the wgmma route keeps the one-process sum order:
  training's (a model axis's shard then computes its channels bitwise as
  the whole layer does), a small batch's maps, the shallow heads.
- **The ring.** Resident weights (the group's rows of every pass of the
  block) before streamed ones (each stage carries its pass's rows), the
  deepest ring (float32 2 stages, bfloat16 4) that fits; first within
  half an SM's shared memory where the kernel runs two blocks a SM
  (bfloat16, and float32 at k 1).
- **The persistent walk.** The kernel launches ``n`` clusters, the items
  or as many as the card holds at once if fewer, and cluster ``c`` takes
  the consecutive items ``[c * items // n, (c + 1) * items // n)``.
- **x's pixel stride** ``cs`` (>= Cin): the decoders' inputs come as
  views of buffers padded to whole 16-byte pixel rows (ops/resize.py),
  which TMA stages; the plans decide by the stride, not the channels.
- **The one-image tile** (:func:`_tile_wins`, ``ns`` 0): where x's pixel
  stride is not a whole 16-byte row, which TMA cannot stage, at the 1 x
  1 heads of up to 64 input channels, and at float32 calls of more than
  4 passes whose one-image tiles fill the card (:func:`_tile_fills`:
  training's padded decoders of 258 and 130 channels), the plan keeps
  the one-process mainloop (``csrc/conv_tile.cuh``): one block per 8 x
  32 tile of one image and 32 output channels (8 where Cout <= 8), each
  pass staged by ``cp.async``, then multiplied; same sum order, same
  bits.

**The wgmma route** (:func:`wgmma_route`): bfloat16 K1 and B2 at k 3 on
the deep maps (512 input channels or more in whole 64-channel blocks, 64
output channels or more in whole 16-byte rows: RecEVFlowNet's and
E2VID's gates, the spiking U-Net's 8 x 8 x 8 512-channel cells and 8 x
16 x 16 1024 -> 256 decoder, serving's 1 x 12 x 15 gates) run on the
warpgroup-MMA mainloop of ``csrc/conv_wgmma.cuh``, where the mma.sync
mainloops ran 1.8-4.9x cuDNN's bf16 time (PERF.md). Its sums run in the
tensor core's own fixed order: bitwise repeatable, not the one-process
order (:attr:`ConvPlan.bitwise` is False there).

- **K1** (:func:`_wg_k1_plan`, ``ConvPlan.wgmma``): tiles of ``WG_TILE`` =
  128 output pixels that span images (:func:`_wg_tiles`: the fewest, the
  smaller halo, the wider), channel groups of ``WG_K1_BN`` = 128 (``co``),
  passes of ``WG_CH`` = 64 input channels, the passes split into
  ``slices`` from the shape without Cout (:func:`_wg_slices`: the tiles
  times the slices a quarter of the SMs or more, a power of two, at most
  8), so a model-axis shard of Cout / mp channels runs the whole layer's
  instructions for its channels, the same bits. A unit is a
  tile of a group over a slice; the slices' float32 partials are added in
  slice order by a second launch. ``ns`` is the weight ring's stages
  (boxes of 64 x 128, 16 KB), the deepest that fits beside the two halo
  stages.
- **B2** (:func:`_wg_b2_plan`, ``B2Plan.wgmma``): b2_plan's pixel tiles of
  128, output tiles of 64 input channels (all 9 taps) x 64 output
  channels, chunks of 8 or more pixel tiles only where the output tiles
  are fewer than the SMs (one block a SM; so Cin 1024 x Cout 512 keeps
  its 128 output tiles, 97 % of 132 SMs, where its 4 or 2 pixel tiles
  make no chunk of 8), ``ns`` ring stages of a halo and a g box beside
  the epilogue's tile, the deepest that fits, at most ``WG_DW_NS``.

**K2** (:func:`k2_plan`): conv(x) [+ conv(z_rec)], then the LIF update,
on K1's plan with an item's passes x's, then z_rec's (one process's sum
order), so v' and z' are bitwise the parent tree's K2 wherever K is not
split. It differs from K1 in three places:

- **The one-image tile** (:func:`_k2_tile_wins`) where x's or z_rec's
  pixel stride is not a whole 16-byte row (LIFFireNet's 2-channel input,
  an unpadded decoder input), at one process's shallow, large calls (at
  most 4 passes on 32768 pixels or more, Cout a multiple of 32:
  LIFFireNet's cells, the U-Net's first encoder in training), and, as
  K1's, at float32 calls of more than 4 passes whose tiles fill the card
  (training's padded decoders of 258 and 130 channels), where it measured
  faster; the parent's kernel and bits.
- **Blocks a SM**: one in float32; in bfloat16 two for groups of 8 and 16
  (within half an SM's shared memory), one for groups of 32, whose LIF
  state in registers leaves no room for a second block; a feedforward
  cell whose last pass is partial (the decoders') takes one block a SM
  first, where groups of 32 measured faster.
- **K split** only at serving's single images of 512 input channels or
  more (1 x 12 x 15 512 -> 512, 1 x 24 x 30 1024 -> 256, the decoder's 1
  x 46 x 60 514 -> 128 in bfloat16), never in training. K1 splits at
  serving's deep maps whose items no group makes fill the card, in one
  round, and, where a group's items do fill it (the decoders' 1 x 46 x
  60 and 1 x 90 x 120), wherever the estimated cost is lower.

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
           "RING_MAX_SLICES", "B2_PIX", "ConvPlan", "B2Plan", "k1_plan",
           "k2_plan", "b2_plan", "ring_smem", "tile_smem", "b2_smem",
           "WG_TILE", "WG_CH", "WG_K1_BN", "WG_DW_BN", "wgmma_route",
           "wg_k1_smem", "wg_b2_smem"]

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
# K2's channel groups that run two blocks a SM in bfloat16 (the kernel's
# launch bounds, csrc/conv_ring.cuh::fused_conv_lif_ring_kernel)
K2_PAIRED_GROUPS = (16, 8)
# K2 keeps the one-image tile at one process's shallow, large calls: at
# most this many passes an item, on at least this many output pixels (128
# full tiles of 8 x 32), Cout a multiple of the tile's 32 channels
# (_k2_tile_wins)
K2_SHALLOW_PASSES = 4
K2_LARGE_PIXELS = 128 * RING_TILE

B2_PIX = 128              # pixels per tile
B2_NS = 4                 # staging buffers, at most
B2_WIDTHS = (32, 16, 8)
B2_IMGS = (1, 2, 4, 8, 16)
_B2_MW, _B2_MAX_WARPS = 3, 8

# the wgmma route (csrc/conv_wgmma.cuh)
WG_TILE = 128             # pixels a tile: K1's M, B2's pixels a stage
WG_CH = 64                # input channels a pass or a B2 output tile
WG_K1_BN = 128            # K1's output channels a unit
WG_DW_BN = 64             # B2's output channels a unit
WG_MIN_CIN = 512          # the deep maps' input channels, at least
WG_ROW = 128              # bytes of a staged pixel or weight row
WG_BARS = 1024            # bytes of mbarriers before the stages
WG_HS = 2                 # K1's halo stages
WG_BOX = 16384            # bytes of a K1 weight box or a B2 g box
WG_MAX_STAGES = 12
WG_K1_SLICES = 8          # K1's slices of the passes, at most
WG_DW_NS = 6              # B2's ring stages, at most
WG_DW_CHUNK_TILES = 8     # B2's pixel tiles a chunk, at least
WG_DW_THREADS = 384       # three consumer warpgroups


def _ceil(a, b):
    return -(-a // b)


def _align(n, a):
    return _ceil(n, a) * a


def _wstride(co):
    """Elements between bfloat16 weight rows of a group of co
    (conv_tile.cuh::wstride), or between g pixels of B2's tile."""
    return 8 if co == 8 else co + 8


class ConvPlan(NamedTuple):
    """The plan of one K1 or K2 call."""

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
    crec: int = 0     # K2: z_rec's channels (0: feedforward, and K1)
    wgmma: bool = False  # K1 on the wgmma route: co 128, passes of 64,
                         # ns the weight ring's stages

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
        """Whether each output's sum runs in the one-process order (never
        on the wgmma route, whose sums run in the tensor core's order)."""
        return self.slices == 1 and not self.wgmma

    @property
    def units(self):
        """The work units: an item over one block's (slice's) passes."""
        return self.items * self.slices

    @property
    def cch(self):
        """Input channels a pass."""
        return WG_CH if self.wgmma else RING_CCH

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

    @property
    def x_passes(self):
        """The passes over x; z_rec's follow them."""
        return _ceil(self.cin, self.cch)

    def pass_channels(self, p):
        """Input channels [c0, c1) of pass ``p`` in its segment (x's, or
        z_rec's after x's) and its padded count."""
        c, p = (self.cin, p) if p < self.x_passes else (
            self.crec, p - self.x_passes)
        c0 = p * self.cch
        c1 = min(c, c0 + self.cch)
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


def _tile_fills(b, h, w, cout, sms):
    """Whether the one-image tile's blocks (8 x 32 pixels of one image, 32
    output channels) are whole tiles of the map and fill one and a half
    blocks an SM: there its two blocks a SM overlap one's staging with the
    other's MMAs."""
    blocks = b * _ceil(h, 8) * _ceil(w, 32) * _ceil(cout, 32)
    return h >= 8 and w >= 32 and 2 * blocks >= 3 * sms


def _tile_wins(b, h, w, cin, cout, k, esize, cs, sms):
    """Where K1 stays on the one-image tile: x's pixel stride not whole
    16-byte rows (TMA cannot stage them, and the ring's thread copies ran
    1.2-1.9x the tile's time at the decoders' 130, 258 and 514 channels
    unpadded); the 1 x 1 heads of up to 64 input channels (one or two
    passes an item, behind the ring's fixed costs: 1.05-1.7x the tile's
    time); and float32 calls of more than 4 passes whose tile fills the
    card (:func:`_tile_fills`: the decoders' padded 8 x 64 x 64 258 -> 64
    and 8 x 128 x 128 130 -> 32 in training, where the ring, one block a
    SM, ran 1.02-1.07x the tile's time, while at 8 x 32 x 32 514 -> 128
    and at serving's single images it ran 0.41-0.82x); H100, PERF.md."""
    if (cs * esize) % 16 != 0 or (k == 1 and cin <= 2 * RING_CCH):
        return True
    return (esize == 4 and _ceil(cin, RING_CCH) > K2_SHALLOW_PASSES
            and _tile_fills(b, h, w, cout, sms))


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


def _ring_plan(b, h, w, cout, k, esize, sms, passes, levels, deep):
    """The ring's plan of a conv with ``passes`` passes of 32 input
    channels an item (K1: x's; K2: x's, then z_rec's): (tw, th, imgs, co,
    slices, ns, resident, smem), or None where nothing fits. ``levels``
    are the (shared-memory budget, blocks a SM, channel groups) to try in
    order: the first tile shape, then the first level, at which a group
    fits. K may be split only where ``deep``."""
    cos = (8,) if cout <= 8 else (32, 16, 8)
    for tw, th, imgs in _k1_tiles(b, h, w, k):
        tiles = _tiles(b, h, w, tw, th, imgs)
        for budget, per_sm, groups in levels:
            cap = sms * per_sm
            # (cost, co, slices, fit): the least cost, the wider group on
            # a tie; K split only at serving's deep single-image shapes,
            # over at most 2 blocks where a block fills an SM (a cluster
            # of more is not held at once): where no group's items fill
            # the card, in one round; where one's do (the decoders' 1 x 46
            # x 60 and 1 x 90 x 120), wherever it costs less
            best, most = None, 0
            for co in cos:
                fit = (_ring_fit(k, co, esize, tw, imgs, passes, 1, budget)
                       if co in groups else None)
                if fit is None:
                    continue
                items = tiles * _ceil(cout, co)
                most = max(most, items)
                cost = _k1_cost(co, esize, items, sms, passes)
                if best is None or cost < best[0]:
                    best = (cost, co, 1, fit)
            if best is None:
                continue
            if deep:
                for co in cos:
                    if co not in groups:
                        continue
                    items = tiles * _ceil(cout, co)
                    for slices in range(2, min(RING_MAX_SLICES, passes,
                                               2 * per_sm) + 1):
                        fit = _ring_fit(k, co, esize, tw, imgs, passes,
                                        slices, budget)
                        if fit is None or (most < cap
                                           and items * slices > cap):
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
            return tw, th, imgs, co, slices, ns, resident, smem
    return None


def _plan(b, h, w, cin, crec, cout, k, passes, ring):
    """The ConvPlan of a ring plan (tw, th, imgs, co, slices, ns,
    resident, smem)."""
    tw, th, imgs, co, slices, ns, resident, smem = ring
    return ConvPlan(b, h, w, cin, cout, k, tw, th, imgs, _ceil(w, tw),
                    _ceil(h, th), _ceil(b, imgs), co, _ceil(cout, co),
                    passes, slices, ns, resident, smem, crec)


def _tile_plan(b, h, w, cin, crec, cout, k, esize, passes):
    """The one-image tile's plan: one block per 8 x 32 tile of one image
    and 32 output channels (8 where Cout <= 8), no ring."""
    co = 8 if cout <= 8 else 32
    return _plan(b, h, w, cin, crec, cout, k, passes,
                 (32, 8, 1, co, 1, 0, False,
                  tile_smem(k, co, esize, max(cin, crec))))


def wgmma_route(cin, cout, k, esize, cs=0, aligned=True):
    """Whether bfloat16 K1 or B2 of ``cin`` -> ``cout`` channels at kernel
    size ``k`` (x's pixels ``cs`` elements apart, 0: ``cin``; ``aligned``:
    x's pointer, and B2's g's, 16-byte aligned) runs on the wgmma route: k 3, the deep
    maps' 512 input channels or more in whole 64-channel blocks, 64 output
    channels or more in whole 16-byte rows (g's TMA boxes), rows TMA can
    stage. The rule is the shape's, so a model-axis shard (Cout / mp of at
    least 64) takes the route with its whole layer."""
    cs = cs or cin
    return (esize == 2 and k == 3 and cin >= WG_MIN_CIN and cin % WG_CH == 0
            and cout >= WG_DW_BN and cout % 8 == 0
            and (cs * esize) % 16 == 0 and aligned)


def _wg_halo(tw, th, imgs, k):
    """Bytes of a 128-pixel tile's halo of 64 bfloat16 channels, from a
    swizzle atom (conv_wgmma.cuh::halo_bytes)."""
    return _align(imgs * (th + k - 1) * (tw + k - 1) * WG_ROW, 1024)


def wg_k1_smem(tw, imgs, k, ns):
    """Dynamic shared memory of K1's wgmma block (conv_wgmma.cu's layout):
    the mbarriers, two halo stages and ns weight boxes of 16 KB."""
    th = WG_TILE // (tw * imgs)
    return WG_BARS + WG_HS * _wg_halo(tw, th, imgs, k) + ns * WG_BOX


def wg_b2_smem(tw, imgs, k, ns):
    """Dynamic shared memory of B2's wgmma block: the mbarriers, ns stages
    of a halo and a g box of 16 KB, and the epilogue's tile: 64 rows (an
    output channel each) of 64 x 9 (input channel, tap) bfloat16 values
    and 16 bytes (or 32 of float32 values and 16 bytes)."""
    th = WG_TILE // (tw * imgs)
    return (WG_BARS + ns * (_wg_halo(tw, th, imgs, k) + WG_BOX)
            + WG_DW_BN * (WG_CH * 9 + 8) * 2)


def _wg_tiles(b, h, w, k):
    """The wgmma route's K1 tile (tw, th, imgs) of 128 pixels: the fewest
    tiles, then the smaller halo, then the wider."""
    shapes = []
    for tw in K1_WIDTHS:
        for imgs in B2_IMGS:
            if tw * imgs <= WG_TILE and (imgs == 1 or imgs <= b):
                th = WG_TILE // (tw * imgs)
                shapes.append((_tiles(b, h, w, tw, th, imgs),
                               imgs * (th + k - 1) * (tw + k - 1), -tw, imgs,
                               tw, th))
    _, _, _, imgs, tw, th = min(shapes)
    return tw, th, imgs


def _wg_slices(tiles, passes, sms):
    """K1's slices of the passes on the wgmma route, from the shape without
    Cout: the tiles times the slices a quarter of the SMs or more (so that
    Cout 512's four channel groups of 128 fill the card), rounded up to a
    power of two, at most WG_K1_SLICES and the passes. 8 x 8 x 8: 4 tiles,
    8 slices; 8 x 16 x 16: 16 tiles, 4; serving's 1 x 12 x 15: 2 tiles, 8,
    the cap, which leaves Cout 512 64 units: 16 slices there ran 1.13x
    faster at Cout 512 but 1.33x slower at Cout 1024 (PERF.md,
    ``kernel_timing.py plans``)."""
    want = _ceil(sms, 4 * tiles)
    return max(1, min(passes, WG_K1_SLICES, 1 << (want - 1).bit_length()))


def _wg_k1_plan(b, h, w, cin, cout, k, sms):
    tw, th, imgs = _wg_tiles(b, h, w, k)
    passes = _ceil(cin, WG_CH)
    slices = _wg_slices(_tiles(b, h, w, tw, th, imgs), passes, sms)
    ns = min(WG_MAX_STAGES, (RING_MAX_SMEM - wg_k1_smem(tw, imgs, k, 0))
             // WG_BOX)
    return ConvPlan(b, h, w, cin, cout, k, tw, th, imgs, _ceil(w, tw),
                    _ceil(h, th), _ceil(b, imgs), WG_K1_BN,
                    _ceil(cout, WG_K1_BN), passes, slices, ns, False,
                    wg_k1_smem(tw, imgs, k, ns), 0, True)


@functools.lru_cache(maxsize=1024)
def k1_plan(b, h, w, cin, cout, k, esize, sms, cs=0, aligned=True):
    """The plan of K1 on x [b, h, w, cin], its pixels ``cs`` elements
    apart (0: ``cin``, contiguous), into ``cout`` channels at kernel
    size ``k`` for elements of ``esize`` bytes (4 float32, 2 bfloat16) on
    a card with ``sms`` SMs. ``aligned``: x's pointer is 16-byte aligned;
    a padded x that is not, which TMA cannot stage, takes the one-image
    tile (the ring's thread copies take contiguous maps only). bfloat16 at
    the deep maps takes the wgmma route (:func:`wgmma_route`)."""
    if wgmma_route(cin, cout, k, esize, cs, aligned):
        return _wg_k1_plan(b, h, w, cin, cout, k, sms)
    passes = _ceil(cin, RING_CCH)
    cs = cs or cin
    if (_tile_wins(b, h, w, cin, cout, k, esize, cs, sms)
            or (cs != cin and not aligned)):
        return _tile_plan(b, h, w, cin, 0, cout, k, esize, passes)
    groups = (32, 16, 8)
    # first within half an SM where the kernel runs two blocks a SM
    # (bfloat16, and float32 at k 1: conv.cu's bounds)
    levels = ((RING_HALF_SMEM, 2, groups), (RING_MAX_SMEM, 1, groups)) if (
        esize == 2 or k == 1) else ((RING_MAX_SMEM, 1, groups),)
    ring = _ring_plan(b, h, w, cout, k, esize, sms, passes, levels,
                      b == 1 and passes >= DEEP_PASSES)
    if ring is None:
        raise ValueError(f"conv2d_same: no K1 plan fits x {(b, h, w, cin)}, "
                         f"Cout {cout}, k {k}")
    return _plan(b, h, w, cin, 0, cout, k, passes, ring)


def _k2_tile_wins(b, h, w, cin, crec, cout, esize, cs, sms):
    """Where K2 stays on the one-image tile, the parent's kernel and bits:
    x's or z_rec's pixel rows not whole 16-byte rows, which TMA cannot
    stage (the U-Net decoders' 130, 258, 514 and 1026 channels,
    LIFFireNet's 2-channel input; there K1's ring lost to the tile,
    :func:`_tile_wins`); and one process's shallow, large calls (Crec 0
    or Cout; at most 4 passes an item, 32768 output pixels or more, whole
    groups of 32 output channels: LIFFireNet's cells, the U-Net's
    64-channel encoder in training), where the tile's blocks fill the
    card two a SM and overlap one's staging with the other's MMAs, while
    the ring's items, a few passes each, leave its split, state and
    epilogue unhidden: there the ring measured 2-16 % slower in float32,
    and 7-18 % in bfloat16 at LIFFireNet's serving map (H100, PERF.md).
    The model axis's shares (Crec != Cout) stay on the ring, which fills
    their groups of 8 or 16 where the tile's 32 would be half empty. And,
    as K1's (:func:`_tile_wins`), float32 calls of more than 4 passes
    whose tile fills the card (the decoders' padded 8 x 64 x 64 258 -> 64
    and 8 x 128 x 128 130 -> 32 in training: the ring 1.07-1.17x the
    tile's time)."""
    if (cs * esize) % 16 != 0 or (crec * esize) % 16 != 0:
        return True
    if crec not in (0, cout):
        return False
    passes = _ceil(cin, RING_CCH) + _ceil(crec, RING_CCH)
    if passes <= K2_SHALLOW_PASSES:
        return cout % 32 == 0 and b * h * w >= K2_LARGE_PIXELS
    return esize == 4 and _tile_fills(b, h, w, cout, sms)


@functools.lru_cache(maxsize=1024)
def k2_plan(b, h, w, cin, crec, cout, k, esize, sms, cs=0, aligned=True):
    """The plan of K2 on x [b, h, w, cin], its pixels ``cs`` elements
    apart (0: ``cin``; ``aligned`` as :func:`k1_plan`'s), and, where
    ``crec`` > 0, z_rec [b, h, w, crec]
    (``crec`` 0: the feedforward cell) into ``cout``
    channels at kernel size ``k`` for elements of ``esize`` bytes on a
    card with ``sms`` SMs: K1's tiles, groups, split and ring over x's
    passes, then z_rec's; one block a SM in float32, and in bfloat16 two
    (within half an SM's shared memory) but at groups of 32, whose LIF
    state in registers takes a block an SM (csrc/conv_ring.cuh)."""
    passes = _ceil(cin, RING_CCH) + _ceil(crec, RING_CCH)
    cs = cs or cin
    if (_k2_tile_wins(b, h, w, cin, crec, cout, esize, cs, sms)
            or (cs != cin and not aligned)):
        return _tile_plan(b, h, w, cin, crec, cout, k, esize, passes)
    groups = (32, 16, 8)
    # bfloat16: two blocks a SM at groups of 8 and 16 first, but for a
    # feedforward cell whose last pass is partial (the decoders' 514, 258
    # and 130 channels), where one block a SM at groups of 32 measured
    # 1.06-1.13x faster than the pair at groups of 16
    paired = esize == 2 and not (crec == 0 and cin % RING_CCH)
    levels = ((RING_HALF_SMEM, 2, K2_PAIRED_GROUPS),
              (RING_MAX_SMEM, 1, groups)) if paired else (
        (RING_MAX_SMEM, 1, groups),)
    # K split only at serving's single-image cells of 512 input channels
    # or more (1 x 12 x 15 512 -> 512, 1 x 24 x 30 1024 -> 256)
    ring = _ring_plan(b, h, w, cout, k, esize, sms, passes, levels,
                      b == 1 and _ceil(cin, RING_CCH) >= 2 * DEEP_PASSES)
    if ring is None:
        raise ValueError(f"fused_conv_lif: no K2 plan fits x "
                         f"{(b, h, w, cin)}, Crec {crec}, Cout {cout}, k {k}")
    return _plan(b, h, w, cin, crec, cout, k, passes, ring)


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
    wgmma: bool = False  # on the wgmma route: cb 64, bn 64, 384 threads

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


def _wg_b2_plan(b, h, w, cin, cout, k, sms, tw, th, imgs, ntiles):
    """B2 on the wgmma route at b2_plan's pixel tile: output tiles of 64 x
    64 channels (all taps), three warpgroups, and the pixels split into
    chunks only where the output tiles are fewer than the SMs (one block a
    SM) and a chunk keeps WG_DW_CHUNK_TILES pixel tiles or more: a chunk's
    float32 partials and their sum cost more than they give on fewer
    (PERF.md, ``kernel_timing.py plans``). The deepest ring that fits, at
    most WG_DW_NS."""
    cblocks, coblocks = _ceil(cin, WG_CH), _ceil(cout, WG_DW_BN)
    out_tiles = cblocks * coblocks
    chunks = 1 if out_tiles >= sms else max(1, min(
        sms // out_tiles, ntiles // WG_DW_CHUNK_TILES))
    per_chunk = _ceil(ntiles, chunks)
    chunks = _ceil(ntiles, per_chunk)
    stage = wg_b2_smem(tw, imgs, k, 1) - wg_b2_smem(tw, imgs, k, 0)
    ns = min(WG_DW_NS, (RING_MAX_SMEM - wg_b2_smem(tw, imgs, k, 0))
             // stage)
    return B2Plan(b, h, w, cin, cout, k, tw, th, imgs, _ceil(w, tw),
                  _ceil(h, th), _ceil(b, imgs), WG_CH, WG_DW_BN, cblocks,
                  coblocks, per_chunk, chunks, ns, WG_DW_THREADS,
                  wg_b2_smem(tw, imgs, k, ns), True)


@functools.lru_cache(maxsize=1024)
def b2_plan(b, h, w, cin, cout, k, esize, sms, cs=0, aligned=True):
    """The plan of B2 on x [b, h, w, cin] (its pixels ``cs`` elements
    apart, 0: ``cin``) and g [b, h, w, cout] at kernel size ``k`` for
    elements of ``esize`` bytes on a card with ``sms`` SMs; bfloat16 at
    the deep maps on the wgmma route (:func:`wgmma_route`; ``aligned``: x's
    and g's pointers 16-byte aligned, as its TMA maps need)."""
    shapes = []
    for tw in B2_WIDTHS:
        for imgs in B2_IMGS:
            if tw * imgs <= B2_PIX and (imgs == 1 or imgs <= b):
                th = B2_PIX // (tw * imgs)
                halo = imgs * (th + k - 1) * (tw + k - 1)
                shapes.append((_tiles(b, h, w, tw, th, imgs), -tw, halo,
                               imgs, tw, th))
    ntiles, _, _, imgs, tw, th = min(shapes)
    if wgmma_route(cin, cout, k, esize, cs, aligned):
        return _wg_b2_plan(b, h, w, cin, cout, k, sms, tw, th, imgs, ntiles)
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
