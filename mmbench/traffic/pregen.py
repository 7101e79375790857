"""World pre-generation: featured areas through ``generate_area_fused`` as fast as one
caller can have them made.

A closed loop of one caller keeps at most ``in_flight`` areas enqueued on the card: it
enqueues an area (the call returns once its launches are queued), records an event after it,
and when ``in_flight`` areas are outstanding waits for the oldest.  The areas' origins are a
fixed pool of ``pool_areas`` distinct chunk coordinates, uniform in ``origin_range`` on both
axes (drawn once from ``pool_seed``), whose chunk positions set-up puts on the card; the
window takes them in an order drawn from the run's seed, a new one each pass over the pool,
so that every seed generates the same areas, about as often.  Set-up warms the path on the
pool's first ``warm_areas`` areas.  Once ``seconds`` have passed the caller issues nothing
more and waits for the areas it has issued; every issued area counts, and the window ends
when the last of them is complete, so that the rate is whole areas over the time they took.

The check: ``sites`` clusters of ``cluster`` x ``cluster`` adjacent chunks of the window's
completed areas, drawn from the seed (one cluster of an area, kept by reservoir sampling over
the completed areas), are regenerated by the plain reference (``reference/chunk.py``
``area_chunks``), which compares their blocks (K1-K8) and the heightfield, biome weights and
layers of their sources (K1, K2); and every column of every completed area has bedrock at
y = 0 (no chunk of an area left out).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..reference import chunk as ref_chunk
from ..reference.world.blocks import Block
from . import Done, sync


BEDROCK = int(Block.BEDROCK)


class Workload:
    def __init__(self, cell, config, seed: int, seconds: float, spans, device):
        self.cell, self.config, self.seconds, self.spans, self.device = cell, config, seconds, spans, device
        tr = cell["traffic"]
        self.n = int(tr["area_chunks"])
        self.features = bool(tr["features"])
        self.in_flight = int(tr["in_flight"])
        self.lo, self.hi = (int(v) for v in tr["origin_range"])
        self.pool_seed, self.pool_areas = int(tr["pool_seed"]), int(tr["pool_areas"])
        self.warm = int(tr["warm_areas"])
        self.n_check = int(cell["check"]["sites"])
        self.k = int(cell["check"]["cluster"])
        self.n_need = int(cell["check"]["need_areas"])
        self.limits = cell["check"]["limits"]
        self.rng = np.random.default_rng([seed, 0])
        self.sample_rng = np.random.default_rng([seed, 1])

    # -- set-up -------------------------------------------------------------------------

    def pool(self):
        """[pool_areas, 2] distinct chunk coordinates (x, z), uniform in the origin range."""
        side = self.hi - self.lo
        idx = np.random.default_rng(self.pool_seed).choice(side * side, size=self.pool_areas, replace=False)
        return np.stack([self.lo + idx % side, self.lo + idx // side], axis=-1)

    def pool_order(self):
        """The window's pool indices: passes over the pool, each in its own order drawn from
        the seed."""
        while True:
            yield from (int(j) for j in self.rng.permutation(self.pool_areas))

    def _pos_halo(self, origins):
        """[A, (n+2)^2, 2] i32 world-block origins of the areas' chunks with their halo, on
        the card."""
        m = self.n + 2
        iz, ix = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
        grid = np.stack([ix, iz], axis=-1).reshape(-1, 2) - 1
        pos = (origins[:, None, :] + grid[None]) * 16
        return torch.as_tensor(pos.astype(np.int32), device=self.device)

    def setup(self):
        from mega_minecraft_tpu_torch.terrain import pipeline

        self.pipeline = pipeline
        self.origins = self.pool()
        self.pool_pos = self._pos_halo(self.origins)
        for j in range(self.warm):
            self.pipeline.generate_area_fused(self.pool_pos[j], self.n, self.n, features=self.features)
        sync(self.device)

    # -- the window ---------------------------------------------------------------------

    def window(self):
        n, feat = self.n, self.features
        gen = self.pipeline.generate_area_fused
        pending = collections.deque()
        self.completed = 0
        self.kept = []  # the check's reservoir: (area, chunk index, sub-area outputs)
        self.need_areas = []  # traced runs: whole outputs of the first areas, for the rooflines
        self.no_bedrock = torch.zeros((), dtype=torch.int64, device=self.device)
        self.area_pool = []  # the pool index of each area issued
        order = self.pool_order()
        issued = 0
        t0 = time.perf_counter()
        deadline = t0 + self.seconds
        while True:
            if len(pending) == self.in_flight or (pending and time.perf_counter() >= deadline):
                ev, i, out = pending.popleft()
                with self.spans.span("wait"):
                    ev.synchronize()
                self._completed(i, out)
                continue
            if time.perf_counter() >= deadline:
                break
            j = next(order)
            with self.spans.span("generate"):
                out = gen(self.pool_pos[j], n, n, features=feat)
                ev = Done(self.device)
            pending.append((ev, issued, out))
            self.area_pool.append(j)
            issued += 1
        sync(self.device)
        self.window_s = time.perf_counter() - t0
        self.issued = issued

    def _completed(self, i, out):
        """Area ``i`` seen complete in the window: counted, its columns without bedrock at
        y = 0 added up on the card, and one of its clusters offered to the reservoir."""
        c = self.completed
        self.completed += 1
        self.no_bedrock += (out["blocks"][..., 0] != BEDROCK).sum()
        if self.spans.traced and len(self.need_areas) < self.n_need:
            self.need_areas.append((i, out))
        slot = c if c < self.n_check else int(self.sample_rng.integers(0, c + 1))
        n, k = self.n, self.k
        ix, iz = (int(v) for v in self.sample_rng.integers(0, n - k + 1, size=2))
        if slot >= self.n_check:
            return
        x0, x1, z0, z1 = ref_chunk.sub_area(n, ix, iz, k)
        rows = torch.as_tensor([zz * n + xx for zz in range(z0, z1 + 1) for xx in range(x0, x1 + 1)],
                               device=self.device)
        cluster = torch.as_tensor([(iz + dz) * n + ix + dx for dz in range(k) for dx in range(k)],
                                  device=self.device)
        kept = {"blocks": out["blocks"].index_select(0, cluster)}
        for key in ("heightfield", "biome_weights", "layers"):
            kept[key] = out[key].index_select(0, rows)
        entry = (i, ix, iz, kept)
        if slot < len(self.kept):
            self.kept[slot] = entry
        else:
            self.kept.append(entry)

    def end_to_end(self):
        return {"gen_chunks_per_s": (self.completed * self.n * self.n / self.window_s, "chunks/s")}

    def release(self):
        del self.pool_pos

    # -- the check ----------------------------------------------------------------------

    def check(self, precision: str = "f32"):
        """Each kept cluster against the plain reference; with ``precision="bf16"`` the
        reference computed in bfloat16 stands in for the program (the control)."""
        if not self.kept:
            return [("chunks_unchecked", 1.0, 0.0)]
        worst = {"blocks_differ": 0.0, "heightfield_max_abs": 0.0, "biome_weights_max_abs": 0.0,
                 "layers_max_abs": 0.0}
        for i, ix, iz, kept in self.kept:
            cx, cz = (int(v) for v in self.origins[self.area_pool[i]])
            want = ref_chunk.area_chunks(cx, cz, self.n, ix, iz, self.k, self.device)
            if precision != "f32":
                kept = ref_chunk.area_chunks(cx, cz, self.n, ix, iz, self.k, self.device, precision=precision)
            worst["blocks_differ"] += float((kept["blocks"] != want["blocks"]).sum())
            for k in ("heightfield", "biome_weights", "layers"):
                d = float((kept[k].double() - want[k].double()).abs().max())
                worst[f"{k}_max_abs"] = max(worst[f"{k}_max_abs"], d)
        out = [(k, v, float(self.limits[k])) for k, v in worst.items()]
        if precision == "f32":
            out.append(("columns_without_bedrock", float(self.no_bedrock), float(self.limits["columns_without_bedrock"])))
        return out

    def attempted(self):
        return self.issued

    # -- per-layer quantities -----------------------------------------------------------

    #: the device operations of each kernel of the rooflines
    KERNELS = {"k3": ("carve_kernel", "column_kernel"), "k4": ("fill_kernel",),
               "k7": ("cull_kernel", "features_kernel")}

    def roofline(self, kernel, trace):
        """Share of its roofline that ``kernel`` reached on the first areas completed in the
        traced window: their need (``roofline.py``) over the device time of their launches.
        An area's launches are found by their order: the profiler may drop a trace's first
        launches, so the j-th area issued is the (count - issued + j)-th occurrence."""
        from .. import roofline

        if not self.need_areas:
            return None
        if not hasattr(self, "_needs"):
            self._needs = {}
            for i, out in self.need_areas:
                base = self.pipeline.generate_area_fused(self.pos_of(i), self.n, self.n,
                                                         features=False)["blocks"]
                self._needs[i] = {"k3": roofline.k3_need(out), "k4": roofline.k4_need(out, base),
                                  "k7": roofline.k7_need(out, base, self.n)}
                del base
        need_ms = dev_ms = 0.0
        for base_name in self.KERNELS[kernel]:
            occ = trace.occurrences(base_name)
            if len(occ) > self.issued:
                return None
            for i, _ in self.need_areas:
                j = len(occ) - self.issued + i
                if j < 0:
                    return None
                a, b = occ[j]
                dev_ms += (b - a) / 1e3
        for i, _ in self.need_areas:
            need_ms += roofline.bound_ms(*self._needs[i][kernel])
        return 100.0 * need_ms / dev_ms if dev_ms > 0 else None

    def pos_of(self, i):
        j = self.area_pool[i]
        return self._pos_halo(self.origins[j : j + 1])[0]
