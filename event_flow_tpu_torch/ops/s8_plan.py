"""The work plan of the int8 conv kernels K1-s8 and K2-s8.

``csrc/conv_s8.cuh`` runs both on one persistent mainloop. This module
decides what depends on the shape alone, and the kernel derives the same
indices from the two numbers it is given (``tw``, ``slices``):

- **Tiles.** The output [B, H, W, Cout] is cut into tiles of
  ``S8_TILE`` = 256 pixels of one image, ``th`` x ``tw`` with ``tw`` one of
  ``S8_WIDTHS`` and ``th`` = 256 / ``tw``: the width that leaves the
  fewest tiles, the wider one on a tie. Tile ``t`` is image ``t //
  (tiles_y * tiles_x)``, row of tiles ``ty``, column ``tx`` in row-major
  order, origin (ty * th, tx * tw).
- **Channel groups** of ``co`` output channels (8 where Cout <= 8, else
  32). Item ``i`` is tile ``i % tiles`` of group ``i // tiles``.
- **Passes.** The K dimension (taps x input channels) is walked in
  passes of 32 input channels: those of x, then those of the recurrent
  input.
- **Slices.** Where the items are fewer than the card's SMs (the deep,
  small maps), each item's passes are split over the ``slices`` blocks of
  a thread-block cluster, which add their int32 sums in distributed
  shared memory; block ``q`` of a cluster takes passes ``[q * passes //
  slices, (q + 1) * passes // slices)``. Integer sums are exact, so the
  split does not change a bit of the result.
- **The persistent walk.** The kernel launches ``n`` clusters, the
  items or as many as the card holds at once if fewer (the occupancy
  API, in the kernel's launch), and cluster ``c`` takes the consecutive
  items ``[c * items // n, (c + 1) * items // n)``.
"""

import functools
from typing import NamedTuple

import torch

__all__ = ["S8_TILE", "S8_WIDTHS", "S8_CCH", "S8_MAX_SLICES", "S8Plan",
           "s8_plan", "sm_count"]

S8_TILE = 256             # output pixels per tile: 8 warps x 32 pixels
S8_WIDTHS = (32, 16, 8)   # tile widths, the wider first
S8_CCH = 32               # input channels per pass
# blocks of a cluster: at most 4, half the portable size (splits over 8
# ran slower on the H100 at the U-Net's deepest cells)
S8_MAX_SLICES = 4


class S8Plan(NamedTuple):
    b: int
    h: int
    w: int
    cout: int
    co: int          # output channels per group
    tw: int          # tile width
    th: int          # tile height
    tiles_x: int
    tiles_y: int
    groups: int
    px: int          # passes of x
    passes: int      # passes of x and of the recurrent input
    slices: int      # blocks per cluster

    @property
    def tiles(self):
        return self.b * self.tiles_y * self.tiles_x

    @property
    def items(self):
        return self.tiles * self.groups

    def item(self, i):
        """(b, y0, x0, co0) of item ``i``: its tile's image and origin and
        its group's first channel."""
        g, t = divmod(i, self.tiles)
        b, r = divmod(t, self.tiles_y * self.tiles_x)
        ty, tx = divmod(r, self.tiles_x)
        return b, ty * self.th, tx * self.tw, g * self.co

    def cluster_items(self, c, n):
        """The items of cluster ``c`` of ``n``."""
        return range(c * self.items // n, (c + 1) * self.items // n)

    def block_passes(self, q):
        """The passes of block ``q`` of a cluster."""
        return range(q * self.passes // self.slices,
                     (q + 1) * self.passes // self.slices)


def _ceil(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=512)
def s8_plan(b, h, w, cin, crec, cout, sms):
    """The plan of an int8 conv of x [b, h, w, cin] (and a recurrent input
    of ``crec`` channels, 0 for none) into ``cout`` channels on a card
    with ``sms`` SMs."""
    tw = min(S8_WIDTHS, key=lambda t: _ceil(h, S8_TILE // t) * _ceil(w, t))
    th = S8_TILE // tw
    co = 8 if cout <= 8 else 32
    tiles_x, tiles_y = _ceil(w, tw), _ceil(h, th)
    groups = _ceil(cout, co)
    px = _ceil(cin, S8_CCH)
    passes = px + _ceil(crec, S8_CCH)
    items = b * tiles_x * tiles_y * groups
    slices = 1
    if items < sms:
        slices = max(1, min(S8_MAX_SLICES, passes, sms // items))
    return S8Plan(b, h, w, cout, co, tw, th, tiles_x, tiles_y, groups, px,
                  passes, slices)


@functools.lru_cache(maxsize=64)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device):
    """The SMs of CUDA ``device``."""
    return _sms(torch.device(device).index
                if torch.device(device).index is not None
                else torch.cuda.current_device())
