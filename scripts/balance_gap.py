"""Quantify the load-balance gap: rectangular weighted shard cuts (what
the SPMD mesh realizes) vs the reference's Hilbert-packed arbitrary
block->rank maps (core/decomposition.f90:532-612) on the real BS / AS
coastline masks.

The SPMD mesh constrains shards to a px x py grid of rectangles (cut
lines follow the wet-point CDF in each axis, the production
mod_decomposition=1 path, with the best mesh factorization per device
count); the Hilbert packing walks wet blocks of a 2^k x 2^k block grid
in curve order, packing ~equal weight per rank with NO shape constraint.
Reported figure: max device wet-load / mean (decomposition.f90:938) —
lower is better; 1.0 is perfect.

Run: python scripts/balance_gap.py   (CPU, ~seconds)
"""

import sys

import numpy as np

sys.path.insert(0, ".")

from ocean_model_arch_tpu.io.mask_io import read_mask
from ocean_model_arch_tpu.parallel import decomposition as dd


def rect_balance(mask: np.ndarray, n_dev: int) -> tuple[float, str]:
    """Best weighted rectangular px x py split over all factorizations
    (weighted cuts per axis; min shard width 8 like the runners)."""
    best, tag = float("inf"), ""
    for px in range(1, n_dev + 1):
        if n_dev % px:
            continue
        py = n_dev // px
        if px > mask.shape[0] // 8 or py > mask.shape[1] // 8:
            continue
        try:
            xe = (dd.weighted_x_edges(mask, px, min_width=8) if px > 1
                  else np.array([0, mask.shape[0]], np.int64))
            ye = (dd.weighted_y_edges(mask, py, min_width=8) if py > 1
                  else np.array([0, mask.shape[1]], np.int64))
        except ValueError:
            continue
        r = dd.xy_balance(mask, xe, ye)
        if r < best:
            best, tag = r, f"{px}x{py}"
    return best, tag


def hilbert_balance(mask: np.ndarray, n_dev: int, order_blocks: int
                    ) -> float:
    dec = dd.block_weights(mask, order_blocks, order_blocks)
    hil = dd.assign_hilbert(dec, n_dev)
    return hil.balance_ratio(n_dev)


def main():
    rows = []
    for name, path, nx, ny, blocks in [
            ("BS 4km", "data/BS/mask_bs4km.txt", 289, 163, 32),
            ("AS 250m", "data/AS/maskAzovCor.txt", 1525, 1115, 64)]:
        mask = np.asarray(read_mask(path, nx, ny))
        for n in (2, 4, 8, 16):
            rb, tag = rect_balance(mask, n)
            hb = hilbert_balance(mask, n, blocks)
            gap = (rb - hb) / hb * 100.0
            rows.append((name, n, tag, rb, hb, gap))
            print(f"{name:8s} n={n:2d}  rect[{tag:5s}] {rb:6.3f}  "
                  f"hilbert[{blocks}x{blocks} blocks] {hb:6.3f}  "
                  f"gap {gap:+6.1f}%", flush=True)
    worst = max(r[-1] for r in rows)
    print(f"worst-case rect-vs-hilbert balance gap: {worst:+.1f}%")


if __name__ == "__main__":
    main()
