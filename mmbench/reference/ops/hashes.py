"""Plain PyTorch version of the integer hash, minstd LCG and sin-dot float hashes.

Port of ``mega_minecraft_tpu/ops/hashes.py:40-494`` with ONE arithmetic mode, the
reference's exact mode: ``_sinhash`` always uses the correctly rounded ``_sin_cr``,
and division / sqrt / sums are plain IEEE f32 operations evaluated left to right.
The CUDA twin of every function here is in ``csrc/mmt_math.cuh``.

uint32 arithmetic is carried in int64 tensors masked with ``& 0xFFFFFFFF`` after each
operation (torch's uint32 support is limited).  Float constants enter as f32 (torch
casts a Python float operand to the tensor's f32 dtype).  Divisors are always tensors
on the operand's device: CUDA torch turns division by a CPU scalar into a multiply by
its reciprocal, which is not IEEE division.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
I64 = torch.int64
M32 = 0xFFFFFFFF

LCG_M = 2147483647  # minstd modulus 2^31 - 1
LCG_A = 48271
_LCG_RANGE = float(LCG_M - 2)  # uniform_real_distribution range m - 2


def f32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """As an f32 tensor (on ``like``'s device for Python numbers)."""
    if isinstance(x, torch.Tensor):
        return x.to(F32)
    return torch.tensor(x, dtype=F32, device=None if like is None else like.device)


def div(a, b) -> torch.Tensor:
    """IEEE f32 a / b with the divisor as a tensor on a's device."""
    a = f32(a) if isinstance(a, torch.Tensor) else f32(a, b)
    return a / f32(b, a)


def u32(x) -> torch.Tensor:
    """As int64 holding a uint32 value (two's-complement wrap, like astype(uint32))."""
    return torch.as_tensor(x).to(I64) & M32


def hash_u32(a) -> torch.Tensor:
    """Integer mixer used for all engine seeding (hashes.py:40-49)."""
    a = u32(a)
    a = ((a + 0x7ED55D16) + (a << 12)) & M32
    a = (a ^ 0xC761C23C) ^ (a >> 19)
    a = ((a + 0x165667B1) + (a << 5)) & M32
    a = ((a + 0xD3A2646C) ^ (a << 9)) & M32
    a = ((a + 0xFD7046C5) + (a << 3)) & M32
    a = (a ^ 0xB55A4F09) ^ (a >> 16)
    return a


def _engine_init(s) -> torch.Tensor:
    """linear_congruential_engine seeding: state = s mod m, 0 -> 1."""
    s = u32(s) % LCG_M
    return torch.where(s == 0, torch.ones_like(s), s)


def seed_1(x) -> torch.Tensor:
    return _engine_init(hash_u32(x))


def seed_3(x, y, z) -> torch.Tensor:
    """hash((1 << 31) | (x << 22) | y) ^ hash(z), int wrap == uint32 wrap."""
    h = (1 << 31) | ((u32(x) << 22) & M32) | u32(y)
    return _engine_init(hash_u32(h) ^ hash_u32(z))


def seed_4(x, y, z, w) -> torch.Tensor:
    h = (1 << 31) | ((u32(x) << 22) & M32) | ((u32(y) << 11) & M32) | u32(w)
    return _engine_init(hash_u32(h) ^ hash_u32(z))


def lcg_next(state) -> torch.Tensor:
    """One minstd step: (48271 * state) mod (2^31 - 1); exact in int64."""
    return (u32(state) * LCG_A) % LCG_M


def lcg_u01(state):
    """One uniform f32 draw in [0, 1]: ((x - 1) as f32) / f32(m - 2); returns (v, state)."""
    state = lcg_next(state)
    v = div((state - 1).to(F32), _LCG_RANGE)
    return v, state


def lcg_uniform(state, lo: float, hi: float):
    v, state = lcg_u01(state)
    return v * (hi - lo) + lo, state  # torch rounds each Python float to f32


# ---------------------------------------------------------------------------
# LCG jumping (hashes.py:116-160): the state after k steps is a^k * s0 mod m, so draw j
# of a stream is one table lookup and one modular multiply.  The JAX package splits
# the product into 16-bit halves for a machine without 64-bit integers; int64 holds
# it whole, with the same result.  The CUDA twin computes a^k by square-and-multiply.
# ---------------------------------------------------------------------------


def lcg_pow_table(n: int) -> np.ndarray:
    """[n] int64 numpy table: a^k mod m for k in [0, n)."""
    out = np.empty(n, np.int64)
    v = 1
    for k in range(n):
        out[k] = v
        v = (v * LCG_A) % LCG_M
    return out


def lcg_mulmod(x, y) -> torch.Tensor:
    """(x * y) mod (2^31 - 1) for values < 2^31 (the product fits int64)."""
    return (u32(x) * u32(y)) % LCG_M


def lcg_value_at(state0, j, pow_table) -> torch.Tensor:
    """The uniform [0, 1] value of 0-based draw ``j`` from ``state0``: equal to calling
    ``lcg_u01`` j + 1 times.  ``pow_table``: int64 tensor from ``lcg_pow_table``."""
    state = lcg_mulmod(pow_table[torch.as_tensor(j).to(I64) + 1], state0)
    return div((state - 1).to(F32), _LCG_RANGE)


# ---------------------------------------------------------------------------
# Correctly rounded f32 sin in double-single arithmetic (hashes.py:170-299).
# Every product and sum is a separate f32 op: no fused multiply-add.
# ---------------------------------------------------------------------------

_SPLIT = 4097.0
_PI_HI = 3.1415927410125732
_PI_MED = -8.742277657347586e-08
_PI_LO = -3.4302490200117637e-15
_INVPI_HI = 0.31830987334251404
_INVPI_LO = 1.2841276486597053e-08
_SIN_COEFF = (
    (-7.647163609812713e-13, -1.2200710471178288e-20),
    (1.6059044372074283e-10, -5.352526511562726e-18),
    (-2.5052107943679403e-08, -4.4176230446483665e-16),
    (2.7557318844628753e-06, 3.793571224297229e-14),
    (-0.00019841270113829523, 2.725596874933456e-12),
    (0.008333333767950535, -4.34617203337595e-10),
    (-0.1666666716337204, 4.967053879312289e-09),
)


def _two_prod(a, b):
    """Exact product a*b = p + e (Dekker, no FMA)."""
    p = a * b
    aa = a * _SPLIT
    ah = aa - (aa - a)
    al = a - ah
    bb = b * _SPLIT
    bh = bb - (bb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _two_sum(a, b):
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _ds_mul(a_hi, a_lo, b_hi, b_lo):
    p, e = _two_prod(a_hi, b_hi)
    e = e + (a_hi * b_lo + a_lo * b_hi)
    return _two_sum(p, e)


def _ds_add(a_hi, a_lo, b_hi, b_lo):
    s, e = _two_sum(a_hi, b_hi)
    e = e + a_lo + b_lo
    return _two_sum(s, e)


def _sin_cr(d):
    """sin(d) correctly rounded to f32 for |d| <= ~2^40 (hashes.py:252-299)."""
    d = f32(d)
    full = lambda c: torch.full_like(d, c)  # noqa: E731
    q_hi, q_e = _two_prod(d, full(_INVPI_HI))
    q_lo = q_e + d * _INVPI_LO
    k0 = torch.round(q_hi)  # half to even, as jnp.round / rintf
    k1 = torch.round((q_hi - k0) + q_lo)
    p1, e1 = _two_prod(k0, full(_PI_HI))
    s1 = d - p1
    t_hi, t_lo = _two_sum(s1, -e1)
    p1b, e1b = _two_prod(k1, full(_PI_HI))
    t_hi, t2 = _two_sum(t_hi, -p1b)
    t_lo = t_lo + t2 - e1b
    p2, e2 = _two_prod(k0, full(_PI_MED))
    u_hi, u_lo = _two_sum(t_hi, -p2)
    k = k0 + k1
    r_hi, r_lo = _two_sum(u_hi, u_lo + t_lo - (e2 + k1 * _PI_MED + k * _PI_LO))
    r2_hi, r2_lo = _ds_mul(r_hi, r_lo, r_hi, r_lo)
    p_hi, p_lo = full(_SIN_COEFF[0][0]), full(_SIN_COEFF[0][1])
    for c_hi, c_lo in _SIN_COEFF[1:]:
        p_hi, p_lo = _ds_mul(p_hi, p_lo, r2_hi, r2_lo)
        p_hi, p_lo = _ds_add(p_hi, p_lo, full(c_hi), full(c_lo))
    r3_hi, r3_lo = _ds_mul(r2_hi, r2_lo, r_hi, r_lo)
    t_hi2, t_lo2 = _ds_mul(r3_hi, r3_lo, p_hi, p_lo)
    s_hi, s_lo = _ds_add(r_hi, r_lo, t_hi2, t_lo2)
    sin_r = s_hi + s_lo
    odd0 = (k0 - 2.0 * torch.floor(k0 * 0.5)) != 0.0
    odd1 = (k1 - 2.0 * torch.floor(k1 * 0.5)) != 0.0
    return torch.where(odd0 ^ odd1, -sin_r, sin_r)


def fract(x):
    return x - torch.floor(x)


def _sinhash(d):
    return fract(_sin_cr(d) * 39021.426)


def rand1_from1(v):
    return _sinhash(f32(v) * 238.68)


def rand1_from2(vx, vy):
    return _sinhash(f32(vx) * 238.68 + f32(vy) * 491.28)


def rand1_from3(vx, vy, vz):
    return _sinhash(f32(vx) * 238.68 + f32(vy) * 491.28 + f32(vz) * 640.88)


def rand2_from2(vx, vy):
    vx, vy = f32(vx), f32(vy)
    return _sinhash(vx * 238.68 + vy * 491.28), _sinhash(vx * 654.37 + vy * 560.45)


def rand2_from3(vx, vy, vz):
    vx, vy, vz = f32(vx), f32(vy), f32(vz)
    return (
        _sinhash(vx * 238.68 + vy * 491.28 + vz * 640.88),
        _sinhash(vx * 654.37 + vy * 560.45 + vz * 151.81),
    )


def rand3_from2(vx, vy):
    vx, vy = f32(vx), f32(vy)
    return (
        _sinhash(vx * 238.68 + vy * 491.28),
        _sinhash(vx * 654.37 + vy * 560.45),
        _sinhash(vx * 640.88 + vy * 151.81),
    )


def rand3_from3(vx, vy, vz):
    vx, vy, vz = f32(vx), f32(vy), f32(vz)
    return (
        _sinhash(vx * 238.68 + vy * 491.28 + vz * 402.98),
        _sinhash(vx * 654.37 + vy * 560.45 + vz * 747.42),
        _sinhash(vx * 640.88 + vy * 151.81 + vz * 674.81),
    )


# ---------------------------------------------------------------------------
# the renderer's per-pixel RNG (hashes.py:473-494; the reference's
# random_number_generators.h): TEA-seeded LCG with 24-bit uniforms
# ---------------------------------------------------------------------------


def tea(val0, val1, rounds: int = 16) -> torch.Tensor:
    """TEA hash of two u32 words -> u32 (held in int64)."""
    v0, v1 = u32(val0), u32(val1)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & M32) ^ ((v1 + s0) & M32)
                    ^ (((v1 >> 5) + 0xC8013EA4) & M32))) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & M32) ^ ((v0 + s0) & M32)
                    ^ (((v0 >> 5) + 0x7E95761E) & M32))) & M32
    return v0


def lcg_render(state) -> torch.Tensor:
    """The renderer's LCG step: state' = 1664525 * state + 1013904223 (mod 2^32)."""
    return (u32(state) * 1664525 + 1013904223) & M32


def rnd(state):
    """Uniform in [0, 1) from the low 24 bits of the next state -> (value, state)."""
    state = lcg_render(state)
    v = (state & 0x00FFFFFF).to(F32) / torch.full_like(state, float(0x01000000), dtype=F32)
    return v, state
