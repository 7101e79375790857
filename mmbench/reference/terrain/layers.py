"""Stage 2: material layers (kernels K2 and K2s).

Port of ``mega_minecraft_tpu/terrain/layers.py:28-127``.  The plain functions keep the
JAX signatures.  ``layers_from_halo`` is the stage as the area pipeline runs it: halo
gather -> ``generate_layers`` -> ``fix_backward_stratified`` (unless erosion follows),
plus the inner-chunk selection of heightfield, weights and origins.  ``layers_slots`` is
the stage as the streaming scheduler runs it (``_stage_layers``): 3x3 slot gather ->
``generate_layers`` -> optional fix -> slot write.  On CUDA each is one launch of
``csrc/layers.cu`` (K2, K2s: the same device code, two ways of addressing); on the CPU
the plain composition.
"""

from __future__ import annotations

import torch

from ..world import biomes as bio

from ..ops.hashes import div, f32
from ..ops.noise import fbm2
from . import gather
from .heightfield import column_world_coords

SQRT_2 = 1.41421356237309504880


def total_material_weights(biome_weights):
    """[B, 24, 16, 16] -> [B, 20, 16, 16]: sum over c = 0..23 of w[c] * BMW[c], in order."""
    bmw = torch.as_tensor(bio.BIOME_MATERIAL_WEIGHTS, device=biome_weights.device)
    acc = torch.zeros(
        (biome_weights.shape[0], bio.NUM_MATERIALS, 16, 16),
        dtype=torch.float32, device=biome_weights.device,
    )
    for c in range(bio.NUM_BIOMES):
        acc = acc + biome_weights[:, c, None] * bmw[c][None, :, None, None]
    return acc


def max_slope(gathered_hf):
    """8-neighbour max slope from the 18x18 gathered heightfield ([B, 18, 18] [z, x])."""
    center = gathered_hf[:, 1:17, 1:17]
    slope = torch.zeros_like(center)
    for i, (dx, dz) in enumerate(bio.DIR_VECS_2D):
        nb = gathered_hf[:, 1 + dz : 17 + dz, 1 + dx : 17 + dx]
        s = torch.abs(nb - center)
        if i % 2 == 1:  # diagonal
            s = s * SQRT_2
        slope = torch.maximum(slope, s)
    return slope


def _stratified_thickness(layer_idx: int, mat_weight, wx, wz):
    th = float(bio.MATERIAL_THICKNESS[layer_idx])
    amp = float(bio.MATERIAL_AMPLITUDE_OR_TAN_REPOSE[layer_idx])
    scale = float(bio.MATERIAL_SCALE_OR_MAX_SLOPE[layer_idx])
    off = (f32(float(layer_idx)) * 5283.64).item()
    n = fbm2(wx * scale + off, wz * scale + off)
    t = torch.clamp_min(th + amp * n, 0.0) * mat_weight
    return torch.where(mat_weight > 0.0, t, 0.0)


def generate_layers(gathered_hf, biome_weights, chunk_pos):
    """Plain stage 2: [B,18,18], [B,24,16,16], [B,2] -> layers [B,20,16,16] (absolute
    start heights; backward-stratified slots 10..11 hold cumulative thicknesses until
    ``fix_backward_stratified``)."""
    wx, wz = (c.to(torch.float32) for c in column_world_coords(chunk_pos))

    tmw = total_material_weights(biome_weights)
    slope = max_slope(gathered_hf)
    max_height = gathered_hf[:, 1:17, 1:17]

    n_fwd = bio.NUM_FORWARD_MATERIALS
    n_strat = bio.NUM_STRATIFIED_MATERIALS
    n_mat = bio.NUM_MATERIALS
    out = [None] * n_mat

    height = torch.zeros_like(max_height)
    for l in range(n_fwd):
        out[l] = height
        if l < n_fwd - 1:
            height = height + _stratified_thickness(l, tmw[:, l], wx, wz)

    height = torch.zeros_like(max_height)
    for l in range(n_strat - 1, n_fwd - 1, -1):
        height = height + _stratified_thickness(l, tmw[:, l], wx, wz)
        out[l] = height

    height = max_height
    for l in range(n_mat - 1, n_strat - 1, -1):
        th = float(bio.MATERIAL_THICKNESS[l])
        mslope = float(bio.MATERIAL_SCALE_OR_MAX_SLOPE[l])
        layer_h = torch.clamp_min(th * div(mslope - slope, mslope), 0.0) * tmw[:, l]
        height = height - layer_h
        out[l] = height

    return torch.stack(out, dim=1)


def fix_backward_stratified(layers):
    """Backward-stratified slots -> absolute starts below the eroded base (layers[12])."""
    n_fwd = bio.NUM_FORWARD_MATERIALS
    n_strat = bio.NUM_STRATIFIED_MATERIALS
    fixed = layers.clone()
    fixed[:, n_fwd:n_strat] = layers[:, n_strat, None] - layers[:, n_fwd:n_strat]
    return fixed


def layers_from_halo_plain(hf_halo, w_halo, pos_halo, ncx: int, ncz: int,
                           fix_backward: bool = True):
    """Plain version of K2: halo'd stage-1 outputs -> inner-chunk dict."""
    inner = gather.inner_indices(ncx, ncz, hf_halo.device)
    gathered = gather.gather_halo_heightfields(hf_halo, ncx, ncz)
    w_in = w_halo[inner].contiguous()
    pos_in = pos_halo[inner].contiguous()
    ls = generate_layers(gathered, w_in, pos_in)
    if fix_backward:
        ls = fix_backward_stratified(ls)
    return {
        "layers": ls,
        "heightfield": hf_halo[inner].contiguous(),
        "biome_weights": w_in,
        "chunk_pos": pos_in,
    }


def layers_from_halo(hf_halo, w_halo, pos_halo, ncx: int, ncz: int, fix_backward: bool = True):
    """Stage 2 over an ncz x ncx area with a 1-chunk halo: K2 on CUDA, plain on CPU.

    Returns dict: layers [B,20,16,16] (fixed unless ``fix_backward`` is false),
    heightfield [B,16,16], biome_weights [B,24,16,16], chunk_pos [B,2] for the
    B = ncz*ncx inner chunks."""
    return layers_from_halo_plain(hf_halo, w_halo, pos_halo, ncx, ncz, fix_backward)


def layers_slots_plain(d_layers, d_hf, d_w, nslots, slots, pos, fix_backward: bool):
    """Plain version of K2s, in place: for each chunk b of the batch, its 18x18 window
    from the heightfields of its 3x3 neighbourhood ``nslots`` [B, 3, 3], its weights
    ``d_w[slots[b]]`` and origin ``pos`` [B, 2] -> ``d_layers[slots[b]]``."""
    hf3 = d_hf[nslots.reshape(-1).long()].reshape(-1, 3, 3, 16, 16)
    ls = generate_layers(gather.gather_heightfields_batch(hf3), d_w[slots.long()], pos)
    if fix_backward:
        ls = fix_backward_stratified(ls)
    d_layers[slots.long()] = ls
    return d_layers


def layers_slots(d_layers, d_hf, d_w, nslots, slots, pos, fix_backward: bool):
    """The scheduler's layers stage over the slot table, in place: K2s on CUDA, the
    plain version on the CPU.  Returns ``d_layers``."""
    return layers_slots_plain(d_layers, d_hf, d_w, nslots, slots, pos, fix_backward)
