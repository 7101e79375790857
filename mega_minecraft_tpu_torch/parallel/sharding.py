"""Programs split over a 1-D device mesh: data-parallel generation, row-banded zone erosion
with halo rows exchanged every sweep, and row-banded rendering.

Port of ``mega_minecraft_tpu/parallel/sharding.py``.  JAX runs these as ``shard_map``
programs, one process driving every device of the mesh; so does this module, with no
``torch.distributed``: each shard's kernels are launched on its device's current stream,
and data moves between shards by ``Tensor.copy_`` / ``Tensor.to`` (peer copies between
cards, plain copies between shards that share one).

- ``dp_generate``: a featureless chunk batch split over the mesh.  Each shard runs K2h
  (``kernels.dp_layers``: the heightfield recomputed over each chunk's own 18x18 window,
  no gather from the neighbouring chunks, then layers with the backward fix) and K4 with
  an empty cave set.
- ``erode_zone_sharded``: a zone's [9, 384, 384] grid split into row bands.  The host owns
  the Jacobi loop: before each sweep every band gets one halo row above and one below from
  its neighbours, each band runs one K9b (``kernels.erosion_band``) sweep, and the bands'
  changed flags are summed on the host (JAX's ``psum``), which decides whether another
  sweep follows.  The result equals K9 (``terrain.erosion.erode_zone``) bit for bit, with
  the same sweep counts.
- ``sharded_render``: the frame's rows split over the mesh; each band is one K11
  (``tracer.render_sample`` with ``row0`` / ``full_height``), keyed by the global pixel,
  so the assembled frame equals one whole-frame ``render_sample`` bit for bit.

A mesh may list one device several times (``Mesh([torch.device("cuda:0")] * 4)``, or
``"cpu"`` n times in the tests): the counterpart of the virtual devices of XLA's
``--xla_force_host_platform_device_count``.  Such a mesh runs every shard's kernels, the
halo copies and the flag reduction for real on one device.  On CPU tensors every stage
runs its plain version.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..render import tracer
from ..render.brickmap import Scene
from ..render.camera import CameraParams
from ..render.sky import SkyParams
from ..terrain import fill, heightfield, layers
from ..terrain.erosion import GRID_BLOCKS, N_ERODED, _relax_once, repose_offsets
from ..world import biomes as bio

F32 = torch.float32


class Mesh:
    """A 1-D mesh: the devices of its shards, in shard order."""

    def __init__(self, devices):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in order of first appearance."""
        return list(dict.fromkeys(self.devices))


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A mesh over the first ``n_devices`` cards (default: all of them).  Raises when fewer
    exist: it never gives fewer shards than asked, and never falls back to the CPU.  (A
    mesh of repeated devices, or of the CPU, is built directly with ``Mesh``.)"""
    found = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(found) if n_devices is None else int(n_devices)
    if n < 1 or n > len(found):
        raise ValueError(f"make_mesh: {n} cards asked for, {len(found)} exist")
    return Mesh(found[:n])


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} {n} must divide by mesh size {parts}")
    return n // parts


# ---------------------------------------------------------------------------
# Data-parallel generation: batch axis split, no communication (sharding.py:58-116).
# ---------------------------------------------------------------------------


def gen_stage_layers_plain(chunk_pos):
    """Plain version of K2h (JAX ``_gen_stage_layers``): [B, 2] i32 chunk origins ->
    (heightfield [B, 16, 16], weights [B, 24, 16, 16], layers [B, 20, 16, 16] with the
    backward fix), from each chunk's own 18x18 heightfield window."""
    B = chunk_pos.shape[0]
    lx = torch.arange(-1, 17, dtype=torch.int32, device=chunk_pos.device)
    wx = (chunk_pos[:, 0, None, None] + lx[None, None, :]).to(F32).expand(B, 18, 18)
    wz = (chunk_pos[:, 1, None, None] + lx[None, :, None]).to(F32).expand(B, 18, 18)
    weights18 = heightfield.biome_weights_from_noise(heightfield.biome_noise(wx, wz))
    h18 = torch.zeros((B, 18, 18), dtype=F32, device=chunk_pos.device)
    for biome, fn in heightfield.HEIGHT_FNS.items():
        w = weights18[..., int(biome)]
        h18 = h18 + torch.where(w > 0.0, w * fn(wx, wz), 0.0)
    hf = h18[:, 1:17, 1:17].contiguous()
    weights = weights18[:, 1:17, 1:17].permute(0, 3, 1, 2).contiguous()
    ls = layers.fix_backward_stratified(layers.generate_layers(h18, weights, chunk_pos))
    return hf, weights, ls


def gen_stage_layers(chunk_pos):
    """Heightfield, weights and fixed layers of a chunk batch from each chunk's own
    window: K2h on CUDA, the plain version on the CPU."""
    if chunk_pos.is_cuda:
        return kernels.dp_layers(chunk_pos)
    kernels.require_cpu(chunk_pos)
    return gen_stage_layers_plain(chunk_pos)


def gen_stage_fill(hf, weights, ls, chunk_pos):
    """Fill with an empty cave set (JAX ``_gen_stage_fill``): K4 on CUDA, plain on the CPU."""
    empty_caves = torch.full((chunk_pos.shape[0], 16, 16, bio.MAX_CAVE_LAYERS_PER_COLUMN),
                             384, dtype=torch.int32, device=chunk_pos.device)
    return fill.fill_chunks(hf, weights, ls, empty_caves, empty_caves, chunk_pos)


def dp_generate(mesh: Mesh, chunk_pos):
    """Generate a featureless chunk batch split over the mesh's shards (batch axis).

    ``chunk_pos`` [B, 2] i32 world-block origins, B a multiple of the mesh size.  Each
    shard's B / n chunks go to its device, which runs K2h then K4 with no cave carved.
    Returns the blocks [B, 16, 16, 384] u8 on ``mesh.devices[0]``, in batch order.  (JAX's
    ``height_fns`` and ``staged`` only cut XLA:CPU compile time and are not ported.)"""
    b = _split(chunk_pos.shape[0], mesh.size, "batch")
    blocks = []
    for i, dev in enumerate(mesh.devices):
        pos = chunk_pos[i * b:(i + 1) * b].to(dev, non_blocking=True).contiguous()
        blocks.append(gen_stage_fill(*gen_stage_layers(pos), pos))
    d0 = mesh.devices[0]
    return torch.cat([x.to(d0, non_blocking=True) for x in blocks])


# ---------------------------------------------------------------------------
# Row-banded zone erosion with halo rows exchanged every sweep (sharding.py:124-225).
# ---------------------------------------------------------------------------


def erosion_band_plain(start, end, acc_in, acc_out, dst, top_edge: bool, bottom_edge: bool,
                       rel: int, flags, k: int) -> None:
    """Plain version of K9b (``kernels.erosion_band``; JAX ``_relax_sharded`` and
    ``_wrote_mask_sharded``), in place, on [rows + 2, 384] buffers whose first and last
    rows are the halo rows (an edge band reads its own border row there instead)."""
    rows = start.shape[0] - 2
    first = acc_in is not None
    S, E = (start + acc_in, end + acc_in) if first else (start, end)
    offs = torch.as_tensor(repose_offsets()[rel], device=start.device)
    clamp = (0 if top_edge else -1, rows - 1 if bottom_edge else rows)
    new_start, wrote, changed = _relax_once(S, E, offs, clamp, halo=1)
    zero = torch.zeros((), dtype=F32, device=start.device)
    base = acc_in if first else acc_out
    acc_out[1:rows + 1] = base[1:rows + 1] + torch.where(changed, new_start - S[1:rows + 1], zero)
    dst[1:rows + 1] = torch.where(wrote, new_start, start[1:rows + 1])
    flags[(k + 1) & 1] = 0
    if bool(changed.any()):
        flags[k & 1] = 1


def erosion_band(start, end, acc_in, acc_out, dst, top_edge: bool, bottom_edge: bool, rel: int,
                 flags, k: int) -> None:
    """One sweep of a band: K9b on CUDA, the plain version on the CPU."""
    if start.is_cuda:
        kernels.erosion_band(start, end, acc_in, acc_out, dst, top_edge, bottom_edge, rel, flags, k)
        return
    kernels.require_cpu(start)
    erosion_band_plain(start, end, acc_in, acc_out, dst, top_edge, bottom_edge, rel, flags, k)


def _exchange_halos(bufs) -> None:
    """Fill each band's halo rows (first and last of the row axis, which is the one before
    last) from its neighbours' border rows (JAX's two ``ppermute``); the edge bands' outer
    halo rows stay unused."""
    n = len(bufs)
    for i in range(n):
        rows = bufs[i].shape[-2] - 2
        if i > 0:
            bufs[i][..., 0, :].copy_(bufs[i - 1][..., rows, :], non_blocking=True)
        if i < n - 1:
            bufs[i][..., rows + 1, :].copy_(bufs[i + 1][..., 1, :], non_blocking=True)


def erode_zone_sharded(mesh: Mesh, gathered_layers, iterations: list | None = None):
    """Row-banded ``erode_zone``: [9, 384, 384] f32 with its rows split over the mesh.

    Follows JAX's layer loop (``erode_zone_sharded``, sharding.py:171-193), top layer
    first: the first sweep reads ``g[rel] + accum`` and ``g[rel + 1] + accum``, later sweeps
    the layer and ``g[rel + 1]``; a sweep follows while any band changed a column.  Before
    the first sweep of a layer the bands exchange the halo rows of the sums and of the end
    (the layer above, final by then; the raw layers' halos are exchanged once at the
    start), before every later sweep those of the layer.  Returns the eroded grid on
    ``mesh.devices[0]``, and appends each layer's sweep count, top layer first, to
    ``iterations`` when given."""
    n = mesh.size
    rows = _split(GRID_BLOCKS, n, "grid rows")
    halo = (rows + 2, GRID_BLOCKS)
    g_in, acc, tmp = [], [], []
    for i, dev in enumerate(mesh.devices):
        g = torch.empty((N_ERODED + 1, *halo), dtype=F32, device=dev)
        g[:, 1:rows + 1].copy_(gathered_layers[:, i * rows:(i + 1) * rows], non_blocking=True)
        g_in.append(g)
        acc.append(torch.zeros((2, *halo), dtype=F32, device=dev))
        tmp.append(torch.empty(halo, dtype=F32, device=dev))
    _exchange_halos(g_in)
    out = [g.clone() for g in g_in]  # layer 8, the heightfield, is the top layer's end
    # one [bands on the device, 2] flag tensor per device; each band uses its own row
    flag_of = {dev: torch.zeros((mesh.devices.count(dev), 2), dtype=torch.int32, device=dev)
               for dev in mesh.distinct_devices()}
    flags = [flag_of[dev][mesh.devices[:i].count(dev)] for i, dev in enumerate(mesh.devices)]

    def sweep(k, rel, src, dst, acc_in, acc_out):
        for i in range(n):
            erosion_band(src[i], out[i][rel + 1], None if acc_in is None else acc[i][acc_in],
                         acc[i][acc_out], dst[i], i == 0, i == n - 1, rel, flags[i], k)
        # the psum: every band's flag of this sweep, read and summed on the host
        return sum(int(f.cpu()[:, k & 1].sum()) for f in flag_of.values()) > 0

    k = 0  # sweeps over all layers (selects the flag slot)
    cur = 0  # the sums this layer's first sweep reads
    for rel in range(N_ERODED - 1, -1, -1):
        if rel < N_ERODED - 1:
            _exchange_halos([o[rel + 1] for o in out])
        _exchange_halos([a[cur] for a in acc])
        layer = [o[rel] for o in out]
        go = sweep(k, rel, [g[rel] for g in g_in], layer, cur, cur ^ 1)
        k += 1
        sweeps = 1
        src, dst = layer, tmp
        while go:
            _exchange_halos(src)
            go = sweep(k, rel, src, dst, None, cur ^ 1)
            k += 1
            sweeps += 1
            src, dst = dst, src
        if src is tmp:  # the last sweep wrote tmp: equal to the layer but for signed zeros
            for i in range(n):
                layer[i][1:rows + 1].copy_(tmp[i][1:rows + 1])
        if iterations is not None:
            iterations.append(sweeps)
        cur ^= 1
    d0 = mesh.devices[0]
    return torch.cat([o[:, 1:rows + 1].to(d0, non_blocking=True) for o in out], dim=1)


# ---------------------------------------------------------------------------
# Image-row-banded rendering: scene replicated, rays data-parallel (sharding.py:233-281).
# ---------------------------------------------------------------------------


def _replicate(scene: Scene, cam, params, dev):
    return (Scene(scene.flat.to(dev, non_blocking=True), scene.origin, scene.dims),
            CameraParams(*(t.to(dev, non_blocking=True) for t in cam)),
            SkyParams(*(t.to(dev, non_blocking=True) for t in params)))


def sharded_render(mesh: Mesh, scene: Scene, cam, params, height: int, width: int, frame_id: int):
    """``render_sample`` with the frame's rows split over the mesh: shard i renders rows
    [i * height / n, (i + 1) * height / n) as one ``render_sample(..., row0=, full_height=)``
    (one K11 launch on the card).  The scene, camera and sky parameters go to each distinct
    device once.  Rays are keyed by the global pixel, so the frame equals a whole-frame
    ``render_sample`` bit for bit.  Returns (color, albedo, normal) [height, width, 3] f32
    on ``mesh.devices[0]``.  JAX's ``tile_rows``, ``tile_cols`` and ``compact`` schedule
    XLA's tiles and compaction; K11 runs one thread a pixel and has neither, so they are
    not ported."""
    rows = _split(height, mesh.size, "height")
    replicas = {dev: _replicate(scene, cam, params, dev) for dev in mesh.distinct_devices()}
    bands = [tracer.render_sample(*replicas[dev], rows, width, frame_id, row0=i * rows,
                                  full_height=height)
             for i, dev in enumerate(mesh.devices)]
    d0 = mesh.devices[0]
    return tuple(torch.cat([b[j].to(d0, non_blocking=True) for b in bands]) for j in range(3))
