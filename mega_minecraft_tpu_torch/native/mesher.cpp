// Native meshing core: visible-face quad extraction over a padded block volume.
//
// The port's copy of mega_minecraft_tpu/native/mesher.cpp, unchanged below this
// comment.  The CPU-side hot loop the reference also runs natively (its
// terrain/chunk.cu:1781-2003 Chunk::createVBOs: a 16x16x384 block scan per chunk on the
// host).  native/__init__.py builds it with g++ into build/native/ at first use and
// loads it with ctypes; render/meshing.py falls back to its numpy scan when the build
// fails.

#include <cstdint>
#include <cstring>

extern "C" {

// Transparency classes (world/blocks.py Transparency)
enum Trans : uint8_t { T_OPAQUE = 0, T_SEMI = 1, T_TRANSPARENT = 2, T_X_SHAPED = 3 };

static const int DIRS[6][3] = {
    // (dx, dy, dz) in the reference's order (enums.hpp:43-50): +z +x -z -x +y -y
    {0, 0, 1}, {1, 0, 0}, {0, 0, -1}, {-1, 0, 0}, {0, 1, 0}, {0, -1, 0},
};

// quad corner offsets per direction (chunk.cu:1768-1775)
static const float QUAD[6][4][3] = {
    {{0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}},
    {{1, 0, 1}, {1, 0, 0}, {1, 1, 0}, {1, 1, 1}},
    {{1, 0, 0}, {0, 0, 0}, {0, 1, 0}, {1, 1, 0}},
    {{0, 0, 0}, {0, 0, 1}, {0, 1, 1}, {0, 1, 0}},
    {{0, 1, 1}, {1, 1, 1}, {1, 1, 0}, {0, 1, 0}},
    {{0, 0, 0}, {1, 0, 0}, {1, 0, 1}, {0, 0, 1}},
};

static inline int idx18(int z, int x, int y) { return (z * 18 + x) * 384 + y; }

static inline bool should_display(uint8_t this_trans, uint8_t nb_block,
                                  uint8_t nb_trans) {
  // transparency rules (chunk.cu:1913-1927)
  if (this_trans == T_OPAQUE || this_trans == T_SEMI) {
    return nb_trans != T_OPAQUE;
  }
  // T_TRANSPARENT
  return nb_block == 0 /*AIR*/ || nb_trans == T_SEMI;
}

// Pass 1: count emitted quads (regular faces; X-shaped handled in Python — they
// are rare and carry seeded-RNG jitter).
//
// padded: [18, 18, 384] u8 block ids with 1-block xz halo (0 = missing neighbor,
//         marked by halo_valid flags for the 4 sides: +z +x -z -x).
// trans:  [num_blocks] u8 transparency class per block id.
// Returns quad count.
int64_t count_faces(const uint8_t* padded, const uint8_t* trans,
                    const uint8_t halo_valid[4]) {
  int64_t count = 0;
  for (int z = 1; z <= 16; ++z) {
    for (int x = 1; x <= 16; ++x) {
      const uint8_t* col = padded + idx18(z, x, 0);
      for (int y = 0; y < 384; ++y) {
        uint8_t b = col[y];
        if (b == 0) continue;
        uint8_t tt = trans[b];
        if (tt == T_X_SHAPED) continue;
        for (int d = 0; d < 6; ++d) {
          int nx = x + DIRS[d][0], ny = y + DIRS[d][1], nz = z + DIRS[d][2];
          if (ny < 0 || ny >= 384) {
            ++count;  // out-of-range vertical faces always emit (chunk.cu:1881)
            continue;
          }
          // missing xz neighbor -> face culled (null neighbor, chunk.cu:1904-1907)
          if (nx == 0 && !halo_valid[3]) continue;
          if (nx == 17 && !halo_valid[1]) continue;
          if (nz == 0 && !halo_valid[2]) continue;
          if (nz == 17 && !halo_valid[0]) continue;
          uint8_t nb = padded[idx18(nz, nx, ny)];
          if (should_display(tt, nb, trans[nb])) ++count;
        }
      }
    }
  }
  return count;
}

// Pass 2: emit faces. Outputs (per quad): face_pos [3]i32 (local block coords),
// dir u8, block u8. Vertex expansion + UV RNG stays in Python (needs the seeded
// LCG parity helpers).
int64_t emit_faces(const uint8_t* padded, const uint8_t* trans,
                   const uint8_t halo_valid[4], int32_t* out_pos, uint8_t* out_dir,
                   uint8_t* out_block, int64_t cap) {
  int64_t n = 0;
  for (int z = 1; z <= 16; ++z) {
    for (int x = 1; x <= 16; ++x) {
      const uint8_t* col = padded + idx18(z, x, 0);
      for (int y = 0; y < 384; ++y) {
        uint8_t b = col[y];
        if (b == 0) continue;
        uint8_t tt = trans[b];
        if (tt == T_X_SHAPED) continue;
        for (int d = 0; d < 6; ++d) {
          int nx = x + DIRS[d][0], ny = y + DIRS[d][1], nz = z + DIRS[d][2];
          bool emit;
          if (ny < 0 || ny >= 384) {
            emit = true;
          } else if ((nx == 0 && !halo_valid[3]) || (nx == 17 && !halo_valid[1]) ||
                     (nz == 0 && !halo_valid[2]) || (nz == 17 && !halo_valid[0])) {
            emit = false;
          } else {
            uint8_t nb = padded[idx18(nz, nx, ny)];
            emit = should_display(tt, nb, trans[nb]);
          }
          if (emit && n < cap) {
            out_pos[n * 3 + 0] = x - 1;
            out_pos[n * 3 + 1] = y;
            out_pos[n * 3 + 2] = z - 1;
            out_dir[n] = (uint8_t)d;
            out_block[n] = b;
            ++n;
          }
        }
      }
    }
  }
  return n;
}

// Solidity histogram over a volume — used by the streaming runtime for occupancy
// stats without a device round-trip.
void block_histogram(const uint8_t* blocks, int64_t n, int64_t* out_counts256) {
  std::memset(out_counts256, 0, 256 * sizeof(int64_t));
  for (int64_t i = 0; i < n; ++i) ++out_counts256[blocks[i]];
}

}  // extern "C"
