"""CLI demo: generate an area, print its block histogram and an ASCII shade map of the
heightfield; optionally path-trace a frame of it to PNG / PPM.

Usage:
    python -m mega_minecraft_tpu_torch.app.generate_demo [--chunks N] [--origin CX CZ]
        [--device cuda|cpu] [--features] [--render OUT] [--width W] [--height H] [--spp N]

``--features`` also places SDF features and decorators and prints the blocks only they
write (logs, leaves, corals, flora).  ``--render OUT`` builds the area's scene (K10),
accumulates ``--spp`` 1-spp samples of one frame (K11 + K12 each), denoises (K14) and
tonemaps it (K16), and writes it with PIL where it is installed, else as a binary PPM
(``.ppm`` appended to a path without it).  Port of ``mega_minecraft_tpu/app/generate_demo.py``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
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


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chunks", type=int, default=5, help="area side length in chunks")
    p.add_argument("--origin", type=int, nargs=2, default=None, metavar=("CX", "CZ"))
    p.add_argument("--device", default="cuda", help="torch device to generate on (cuda or cpu)")
    p.add_argument("--features", action="store_true", help="also place SDF features and decorators")
    p.add_argument("--render", default=None, metavar="OUT", help="trace a frame to this PNG / PPM")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--spp", type=int, default=8, help="accumulated samples when rendering")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
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

    if args.render:
        u8 = render_frame(out["blocks"], float(hf.max()), cx0, cz0, args.width, args.height, args.spp)
        path = write_image(args.render, u8)
        print(f"\nwrote {path}  (min/max/mean {u8.min()}/{u8.max()}/{u8.mean():.1f})")
    return 0


def render_frame(blocks: torch.Tensor, h_max: float, cx0: int, cz0: int, width: int, height: int,
                 spp: int) -> np.ndarray:
    """The demo's frame of the area ``blocks`` [n, n, 16, 16, 384] u8 whose first chunk is
    (cx0, cz0): the scene, ``spp`` accumulated samples from a camera 40 blocks before the
    area and 14 above its highest column, denoised and tonemapped -> [height, width, 3] u8."""
    from ..render import brickmap, camera, denoise, sky, tonemap, tracer

    n = blocks.shape[0]
    dev = blocks.device
    scene = brickmap.build_scene(blocks, cx0, cz0)
    player = camera.Player(pos=np.array([(cx0 + n / 2) * 16, h_max + 14.0, cz0 * 16 - 40.0], np.float32),
                           theta=0.0, phi=-0.3)
    cam = player.camera_params(width, height, device=dev)
    params = sky.sky_params(1.0, 0.0, device=dev)
    fbs = tracer.init_framebuffers(height, width, device=dev)
    for fid in range(spp):
        c, a, nn = tracer.render_sample(scene, cam, params, height, width, fid)
        fbs = tracer.accumulate(fbs, c, a, nn, fid)
    img = denoise.atrous_denoise(fbs.color, fbs.albedo, fbs.normal)
    return tonemap.present(img).cpu().numpy()


def write_image(path: str, u8: np.ndarray) -> str:
    """Write [H, W, 3] u8 with PIL where it is installed, else as a binary PPM (``.ppm``
    appended to a path without it).  Returns the path written."""
    try:
        from PIL import Image
    except ImportError:
        if not path.endswith(".ppm"):
            path += ".ppm"
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (u8.shape[1], u8.shape[0]) + u8.tobytes())
        return path
    Image.fromarray(u8).save(path)
    return path


if __name__ == "__main__":
    sys.exit(main())
