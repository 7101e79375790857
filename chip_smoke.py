#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mega_minecraft_tpu_torch``) once on one GPU.

Usage (from the root of a checkout, on a machine with one CUDA GPU):

    python3 chip_smoke.py [--ptxas]

Phases, each of which raises (non-zero exit) on failure:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the four kernels from ``mega_minecraft_tpu_torch/csrc`` with nvcc;
  3. hold each kernel K1-K4 against its plain PyTorch version on the card, on the
     5 golden chunks plus 2 seeded ones;
  4. hold K1-K3 against ``tests/golden/golden_chunks.npz`` at tests/test_golden.py's
     gates;
  5. generate the featureless 5x5 bench area (the main path) through
     ``pipeline.generate_area_fused`` with the launch counts reset just before and
     read just after (exactly one launch per kernel); hold each kernel at the 5x5
     shapes, and every output of the 5x5 run, against the plain versions on the
     same inputs; then generate the 33x33 area (launch counts reset again) and check
     that its middle 5x5 chunks equal the 5x5 run bit for bit and that every column
     has bedrock at y = 0;
  6. time the slice and every kernel (and its plain version at the 5x5 shapes)
     warm with CUDA events.
On the card, kernel and plain version run the same libm, so integer outputs must be
equal; float outputs are held to max |diff| <= 1e-3 with >= 99.9% within 1e-5.
The second-to-last line is the kernels' JSON record (launch counts of the 5x5 run,
max |diff| over phases 3 and 5), the last the device record.  ``--ptxas`` also
prints each kernel's registers / spills (nvcc -Xptxas -v).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "golden_chunks.npz"
GOLDEN_CHUNKS = [(0, 0), (592, -368), (-1024, 2048), (4096, 4096), (-160, -160)]
SEED = 20261016

KERNELS = {  # name -> (source, the JAX program it replaces)
    "heightfield": ("mega_minecraft_tpu_torch/csrc/heightfield.cu",
                    "mega_minecraft_tpu/terrain/heightfield.py:299"),
    "layers": ("mega_minecraft_tpu_torch/csrc/layers.cu",
               "mega_minecraft_tpu/terrain/layers.py:60"),
    "caves": ("mega_minecraft_tpu_torch/csrc/caves.cu",
              "mega_minecraft_tpu/terrain/caves.py:175"),
    "fill": ("mega_minecraft_tpu_torch/csrc/fill.cu",
             "mega_minecraft_tpu/terrain/fill.py:283"),
}


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def close_stats(got, want):
    d = (got.double() - want.double()).abs()
    return float(d.max()), float((d <= 1e-5).double().mean())


def check_close(name, got, want):
    """Heightfield / weights / layers tolerance: max |diff| <= 1e-3 and >= 99.9% of
    values within 1e-5 (f32 noise chains; pow / sin go through each platform's libm)."""
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    mx, frac = close_stats(got, want)
    print(f"  {name}: max |diff| {mx:.3g}, within 1e-5: {frac:.6f}")
    check(mx <= 1e-3 and frac >= 0.999, f"{name}: max {mx} / frac {frac} outside 1e-3 / 0.999")
    return mx


def check_equal(name, got, want):
    """Integer outputs (block ids, cave layers, origins) must be equal."""
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(got.dtype == want.dtype, f"{name}: dtype {got.dtype} != {want.dtype}")
    n_diff = int((got != want).sum())
    mx = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
    print(f"  {name}: {n_diff} of {got.numel()} differ, max |diff| {mx:g}")
    check(n_diff == 0, f"{name}: {n_diff} values differ from the plain version")
    return mx


def check_area(n, out, bedrock):
    """Shape, dtype, finiteness and bedrock at y = 0 of an n x n area's outputs."""
    b = out["blocks"]
    check(tuple(b.shape) == (n * n, 16, 16, 384) and b.dtype == torch.uint8, f"{n}x{n} blocks shape")
    for k in ("heightfield", "biome_weights", "layers"):
        check(bool(torch.isfinite(out[k]).all()), f"{n}x{n} {k} not finite")
    check(bool((b[..., 0] == bedrock).all()), f"{n}x{n}: a column lacks bedrock at y=0")


def halo_positions(ox, oz, device):
    """[9, 2] i32 origins of the 3x3 chunks around world-block origin (ox, oz)."""
    pos = [[ox + 16 * dx, oz + 16 * dz] for dz in (-1, 0, 1) for dx in (-1, 0, 1)]
    return torch.tensor(pos, dtype=torch.int32, device=device)


def cuda_ms(fn, reps):
    fn()  # warm
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main(argv):
    p = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port once on one GPU.")
    p.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v output")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: chip_smoke needs a CUDA GPU")

    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.app.generate_demo import histogram_lines
    from mega_minecraft_tpu_torch.kernels import _build
    from mega_minecraft_tpu_torch.terrain import caves, fill, gather, heightfield, layers, pipeline

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device --------------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    # -- 2. build -----------------------------------------------------------------------
    _, build_s, built = _build.build(verbose=args.ptxas)
    _build.load()
    print(f"phase 2: kernels built in {build_s:.1f} s (nvcc ran: {built})")

    rng = np.random.default_rng(SEED)
    seeded = [tuple(int(v) * 16 for v in rng.integers(-4096, 4096, 2)) for _ in range(2)]
    origins = GOLDEN_CHUNKS + seeded
    err = {}

    # -- 3. kernels vs their plain versions, same inputs ---------------------------------
    print(f"phase 3: kernels vs plain versions on {origins}")
    pos7 = torch.tensor(origins, dtype=torch.int32, device=dev)
    hf_k, w_k = kernels.heightfield(pos7)
    hf_p, w_p = heightfield.generate_heightfield_plain(pos7)
    err["heightfield"] = max(check_close("K1 heightfield", hf_k, hf_p),
                             check_close("K1 weights", w_k, w_p))

    st_k, st_p = [], []
    for ox, oz in origins:
        ph = halo_positions(ox, oz, dev)
        hf_h, w_h = heightfield.generate_heightfield_plain(ph)
        st_k.append(kernels.layers(hf_h, w_h, ph, 1, 1))
        st_p.append(layers.layers_from_halo_plain(hf_h, w_h, ph, 1, 1))
    cat = lambda sts, k: torch.cat([s[k] for s in sts])  # noqa: E731
    err["layers"] = check_close("K2 layers", cat(st_k, "layers"), cat(st_p, "layers"))
    for k in ("heightfield", "biome_weights", "chunk_pos"):
        check(torch.equal(cat(st_k, k), cat(st_p, k)), f"K2 {k}: gather differs")
    hf_in, w_in, pos_in, ls_in = (cat(st_p, k) for k in ("heightfield", "biome_weights", "chunk_pos", "layers"))

    cv_k = kernels.caves(hf_in, w_in, pos_in)
    cv_p = caves.generate_caves_plain(hf_in, w_in, pos_in)
    err["caves"] = max(check_equal(f"K3 {k}", cv_k[k], cv_p[k]) for k in cv_p)

    bl_k = kernels.fill(hf_in, w_in, ls_in, cv_p["starts"], cv_p["ends"], pos_in)
    bl_p = fill.fill_chunks_plain(hf_in, w_in, ls_in, cv_p["starts"], cv_p["ends"], pos_in)
    err["fill"] = check_equal("K4 blocks", bl_k, bl_p)

    # -- 4. goldens at test_golden.py's gates ---------------------------------------------
    print("phase 4: K1-K3 vs tests/golden/golden_chunks.npz")
    g = np.load(GOLDEN)
    gpos = torch.tensor(GOLDEN_CHUNKS, dtype=torch.int32, device=dev)
    hf_g, w_g = kernels.heightfield(gpos)
    for i, (cx, cz) in enumerate(GOLDEN_CHUNKS):
        dw = (w_g[i].cpu().numpy() - g[f"weights_{cx}_{cz}"]).__abs__()
        check((dw <= 2e-3).mean() > 0.95 and dw.max() < 0.02, f"K1 weights golden ({cx},{cz})")
        dh = np.abs(hf_g[i].cpu().numpy() - g[f"hf18_{cx}_{cz}"][1:17, 1:17])
        check(np.median(dh) < 0.05 and (dh < 1.0).mean() > 0.98, f"K1 height golden ({cx},{cz})")

        hf18 = torch.as_tensor(g[f"hf18_{cx}_{cz}"], device=dev)
        full = torch.zeros((48, 48), dtype=torch.float32, device=dev)
        full[15:33, 15:33] = hf18
        hf_h = gather.split_chunk_grid(full, 3, 3).reshape(9, 16, 16).contiguous()
        w_h = torch.zeros((9, 24, 16, 16), dtype=torch.float32, device=dev)
        w_h[4] = torch.as_tensor(g[f"weights_{cx}_{cz}"], device=dev)
        got = kernels.layers(hf_h, w_h, halo_positions(cx, cz, dev), 1, 1)["layers"][0]
        ref = torch.as_tensor(g[f"layers_{cx}_{cz}"], device=dev)
        ref = layers.fix_backward_stratified(ref[None])[0]
        max_h = g[f"hf18_{cx}_{cz}"][1:17, 1:17]
        live = np.ones(ref.shape, dtype=bool)  # forward entries the reference wrote
        over = np.zeros(max_h.shape, dtype=bool)
        raw = g[f"layers_{cx}_{cz}"]
        for j in range(1, 10):
            over |= raw[j - 1] > max_h
            live[j] = ~over
        dl = np.abs(got.cpu().numpy() - ref.cpu().numpy())[live]
        check(np.median(dl) < 0.05 and (dl < 1.0).mean() > 0.98, f"K2 layers golden ({cx},{cz})")

        cvg = kernels.caves(hf18[None, 1:17, 1:17].contiguous(), w_h[4:5].contiguous(),
                            gpos[i : i + 1].contiguous())
        s_ok = (cvg["starts"][0].cpu().numpy() == g[f"cavestarts_{cx}_{cz}"])
        e_ok = (cvg["ends"][0].cpu().numpy() == g[f"caveends_{cx}_{cz}"])
        check(s_ok.mean() > 0.95 and e_ok.mean() > 0.95, f"K3 cave layers golden ({cx},{cz})")
        msg = f"  ({cx},{cz}): K1 w {(dw <= 2e-3).mean():.4f} h-median {np.median(dh):.2g}; "
        msg += f"K2 median {np.median(dl):.2g}; K3 starts {s_ok.mean():.4f} ends {e_ok.mean():.4f}"
        if i < 2:
            m = s_ok & (g[f"cavestarts_{cx}_{cz}"] != 384)
            agree = (cvg["bottom_biome"][0].cpu().numpy()[m] == g[f"cavebottom_{cx}_{cz}"][m]).mean()
            check(m.sum() == 0 or agree > 0.97, f"K3 cave biomes golden ({cx},{cz})")
            msg += f" biomes {agree:.4f}"
        print(msg)

    # -- 5. the slice through the pipeline's entry point -----------------------------------
    print("phase 5: the featureless 5x5 bench area through pipeline.generate_area_fused")
    pos5 = pipeline.chunk_positions(-1, -1, 7, 7, device=dev)  # bench.py's 5x5 + halo
    kernels.reset_launch_counts()
    out5 = pipeline.generate_area_fused(pos5, 5, 5)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"  launch counts of the 5x5 run: {launches}")
    for name in KERNELS:
        check(launches[name] == 1, f"kernel {name}: {launches[name]} launches in the 5x5 run, not 1")
    check_area(5, out5, int(fill.Block.BEDROCK))

    print("  each kernel at the 5x5 shapes vs its plain version, same inputs:")
    hf_p, w_p = heightfield.generate_heightfield_plain(pos5)
    hf_k, w_k = kernels.heightfield(pos5)
    err["heightfield"] = max(err["heightfield"], check_close("K1 heightfield", hf_k, hf_p),
                             check_close("K1 weights", w_k, w_p))
    st_p = layers.layers_from_halo_plain(hf_p, w_p, pos5, 5, 5)
    st_k = kernels.layers(hf_p, w_p, pos5, 5, 5)
    err["layers"] = max(err["layers"], check_close("K2 layers", st_k["layers"], st_p["layers"]),
                        *(check_equal(f"K2 {k}", st_k[k], st_p[k])
                          for k in ("heightfield", "biome_weights", "chunk_pos")))
    in3 = (st_p["heightfield"], st_p["biome_weights"], st_p["chunk_pos"])
    cv_p = caves.generate_caves_plain(*in3)
    cv_k = kernels.caves(*in3)
    err["caves"] = max(err["caves"], *(check_equal(f"K3 {k}", cv_k[k], cv_p[k]) for k in cv_p))
    in4 = (*in3[:2], st_p["layers"], cv_p["starts"], cv_p["ends"], in3[2])
    plain5 = fill.fill_chunks_plain(*in4)
    err["fill"] = max(err["fill"], check_equal("K4 blocks", kernels.fill(*in4), plain5))

    print("  every output of the 5x5 run vs the plain chain:")
    for k in ("heightfield", "biome_weights", "layers"):
        check_close(k, out5[k], st_p[k])
    check_equal("chunk_pos", out5["chunk_pos"], st_p["chunk_pos"])
    for k in cv_p:
        check_equal(f"caves {k}", out5["caves"][k], cv_p[k])
    check_equal("blocks", out5["blocks"], plain5)
    print("  5x5 block histogram (top 14):")
    print("\n".join(histogram_lines(out5["blocks"])))

    print("phase 5b: the 33x33 area (the reference's initial drain)")
    pos33 = pipeline.chunk_positions(-17, -17, 35, 35, device=dev)
    kernels.reset_launch_counts()
    out33 = pipeline.generate_area_fused(pos33, 33, 33)
    torch.cuda.synchronize()
    launches33 = kernels.launch_counts()
    print(f"  launch counts of the 33x33 run: {launches33}")
    for name in KERNELS:
        check(launches33[name] == 1, f"kernel {name}: {launches33[name]} launches in the 33x33 run, not 1")
    check_area(33, out33, int(fill.Block.BEDROCK))
    inner = out33["blocks"].reshape(33, 33, 16, 16, 384)[16:21, 16:21]
    check(torch.equal(inner, out5["blocks"].reshape(5, 5, 16, 16, 384)),
          "5x5 chunks differ from the same chunks of the 33x33 run")
    print("  5x5 == 33x33[16:21, 16:21] bit for bit; bedrock at y=0 in every column of both")

    # -- 6. timing (warm, CUDA events) ----------------------------------------------------
    print("phase 6: timing")
    times = {}
    for n, pos in ((5, pos5), (33, pos33)):
        hf, w = kernels.heightfield(pos)
        st = kernels.layers(hf, w, pos, n, n)
        cv = kernels.caves(st["heightfield"], st["biome_weights"], st["chunk_pos"])
        args_fill = (st["heightfield"], st["biome_weights"], st["layers"], cv["starts"],
                     cv["ends"], st["chunk_pos"])
        calls = {
            "heightfield": (lambda: kernels.heightfield(pos),
                            lambda: heightfield.generate_heightfield_plain(pos)),
            "layers": (lambda: kernels.layers(hf, w, pos, n, n),
                       lambda: layers.layers_from_halo_plain(hf, w, pos, n, n)),
            "caves": (lambda: kernels.caves(*args_fill[:2], args_fill[5]),
                      lambda: caves.generate_caves_plain(*args_fill[:2], args_fill[5])),
            "fill": (lambda: kernels.fill(*args_fill),
                     lambda: fill.fill_chunks_plain(*args_fill)),
        }
        reps = 20 if n == 5 else 3
        for name, (kern, plain) in calls.items():
            if n == 5:  # turns: plain, kernel, kernel, plain
                p1 = cuda_ms(plain, 2)
                k1 = cuda_ms(kern, reps)
                k2 = cuda_ms(kern, reps)
                p2 = cuda_ms(plain, 2)
                times[(name, n)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            else:
                times[(name, n)] = (cuda_ms(kern, reps), None)
        slice_ms = cuda_ms(lambda: pipeline.generate_area_fused(pos, n, n), reps)
        times[("slice", n)] = (slice_ms, None)
        print(f"  {n}x{n} ({n * n} chunks): slice {slice_ms:.3f} ms = "
              f"{n * n / (slice_ms / 1e3):.1f} chunks/s on {smi}")
        for name in KERNELS:
            k, p = times[(name, n)]
            plain_s = f", plain {p:.3f} ms ({p / k:.1f}x)" if p is not None else ""
            print(f"    {name:12s} kernel {k:.3f} ms{plain_s}")

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[(name, 5)][0], "plain_ms": times[(name, 5)][1]}
        for name, (src, rep) in KERNELS.items()
    ]}
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
