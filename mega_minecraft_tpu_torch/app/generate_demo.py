"""CLI demo: generate an area and print its block histogram and an ASCII shade map of
the heightfield.

Usage:
    python -m mega_minecraft_tpu_torch.app.generate_demo [--chunks N] [--origin CX CZ]
        [--device cuda|cpu] [--features]

``--features`` also places SDF features and decorators and prints the blocks only they
write (logs, leaves, corals, flora).  ``--render`` (path tracer) is not ported yet and
raises.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..world.blocks import Block

SHADES = " .:-=+*#%@"

#: name fragments of the blocks that only SDF features and decorators write
_FEATURE_WORDS = (
    "WOOD", "LEAVES", "CORAL", "KELP", "SEAGRASS", "MUSHROOM", "CRYSTAL", "GLOWSTONE",
    "SHROOMLIGHT", "VINES", "CACTUS", "RAFFLESIA", "STEM", "WART", "FUNGUS", "TULIP",
    "GRASS_BOTTOM", "GRASS_TOP", "FERN", "ORCHID", "ALLIUM", "DAISY", "LILY", "PEONY", "LILAC",
    "DANDELION", "POPPY", "CORNFLOWER", "PITCHER", "DEAD_BUSH", "ROOTS", "SPROUTS", "TORCHFLOWER",
)
FEATURE_BLOCKS = frozenset(
    int(b) for b in Block
    if any(w in b.name for w in _FEATURE_WORDS)
    or b.name in ("GRASS", "JUNGLE_GRASS", "SAVANNA_GRASS")
)


def histogram_lines(blocks: torch.Tensor, top: int = 14, only=None) -> list[str]:
    """The ``top`` most common block ids of a u8 block tensor, one line each; with
    ``only`` (a set of ids) the histogram of those ids alone."""
    hist = torch.bincount(blocks.reshape(-1).to(torch.int64), minlength=256).cpu()
    names = {int(b): b.name for b in Block}
    order = [int(b) for b in torch.argsort(hist, descending=True)
             if hist[b] and (only is None or int(b) in only)][:top]
    return [f"  {names.get(b, str(b)):22s} {int(hist[b]):>10d}" for b in order]


def shade_map_lines(hf: torch.Tensor, n: int) -> list[str]:
    """ASCII shade map (darker = lower) of an n x n area's [n*n, 16, 16] heightfield."""
    grid = hf.reshape(n, n, 16, 16).permute(0, 2, 1, 3).reshape(n * 16, n * 16).cpu()
    lo, hi = float(grid.min()), float(grid.max()) + 1e-3
    step = max(1, n * 16 // 48)
    return [
        "  " + "".join(SHADES[int((float(v) - lo) / (hi - lo) * 9.999)] for v in grid[r, ::step])
        for r in range(0, n * 16, step * 2)
    ]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chunks", type=int, default=5, help="area side length in chunks")
    p.add_argument("--origin", type=int, nargs=2, default=None, metavar=("CX", "CZ"))
    p.add_argument("--device", default="cuda", help="torch device to generate on (cuda or cpu)")
    p.add_argument("--features", action="store_true", help="also place SDF features and decorators")
    p.add_argument("--render", default=None, metavar="OUT", help="not ported yet")
    args = p.parse_args(argv)
    if args.render:
        raise NotImplementedError("the path tracer is not ported yet (ROADMAP Queue 1, item 11)")

    from ..terrain import pipeline

    n = args.chunks
    cx0, cz0 = args.origin if args.origin else (-(n // 2), -(n // 2))
    print(f"generating {n}x{n} chunks at origin ({cx0}, {cz0}) on {args.device} ...")
    out = pipeline.generate_area(cx0, cz0, n, n, features=args.features, device=args.device)
    hf = out["heightfield"]
    print(f"\nheightfield min/max: {float(hf.min()):.1f} / {float(hf.max()):.1f}")
    print("block histogram (top 14):")
    print("\n".join(histogram_lines(out["blocks"])))
    if args.features:
        counts = {k: int(v["count"].sum()) for k, v in out["placements"].items()}
        print(f"feature and decorator blocks ({counts['surface']} surface and "
              f"{counts['cave']} cave placements):")
        print("\n".join(histogram_lines(out["blocks"], only=FEATURE_BLOCKS)))
    print("\nheightfield shade map:")
    print("\n".join(shade_map_lines(hf, n)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
