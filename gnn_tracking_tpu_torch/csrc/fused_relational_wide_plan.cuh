// The wide layout's plan (csrc/fused_relational_wide.cu): its route, tile, shared memory, blocks,
// and the backward's chunks and weight-gradient slices, for given widths, edges and card. The
// wrappers read it through fused_relational_wide_plan and only allocate what it names. Plain
// C++ with no CUDA header, so a host compiler builds it alone (the CPU tests do).

#pragma once

#ifdef __CUDACC__
#define WIDE_HD __host__ __device__
#else
#define WIDE_HD
#endif

namespace wide_plan {

constexpr int THREADS = 256;
constexpr int KC = 32;       // weight rows a ring stage
constexpr int NB_MAX = 256;  // weight columns a ring stage
constexpr int STAGES = 2;
constexpr int STAGE_FLOATS = KC * NB_MAX;
constexpr int RING_FLOATS = STAGES * STAGE_FLOATS;
constexpr int TILE_EDGES[2] = {64, 32};  // TE where the tiles fit shared memory, largest first
constexpr int DEVICE_TE = 32;            // TE where the tiles live in device memory
constexpr int BK = 16;                   // wgrad: edges a ring stage
constexpr int BT = 128;                  // wgrad: rows and columns of a block's tile of dW
constexpr long FACTOR_CAP = 256L << 20;  // bytes of the backward's factor rows a chunk, about
// the bf16 tensor-core route: edges a tile, and its weight ring (TC_STAGES stages of NB_MAX
// columns x TC_KT contraction rows, each row TC_SP bf16)
constexpr int TC_TE = 64;
constexpr int TC_KT = 64;
constexpr int TC_SP = TC_KT + 8;
constexpr int TC_STAGE = NB_MAX * TC_SP;
constexpr int TC_STAGES = 3;
constexpr int TC_RING_BYTES = TC_STAGES * TC_STAGE * 2;

// The columns of a ring stage for a product of output width m: 256, or 64 where that pads m less
// (ec.yml-like Fo = 64: a fourth of the threads would work at 256)
WIDE_HD inline int pick_nb(int m) { return (m + 63) / 64 * 64 < (m + 255) / 256 * 256 ? 64 : 256; }
WIDE_HD inline int padded_k(int k) { return (k + 7) / 8 * 8; }

// A tile's floats on the CUDA cores: the forward's A [max(K, H)] (m, then h2) and B [H] (h1); the
// backward's A (m, then g_h1), B (h1, then g_h2), G [Fo] (g_e') and two ReLU-mask words a thread
// and column block (uint64); each [width][TE + 4]; then TE edge ids.
WIDE_HD inline long tile_floats(int k, int h, int fo, bool backward, int te) {
  const long ld = te + 4;
  long f = ((long)(k > h ? k : h) + h) * ld;
  if (backward) f += (long)fo * ld + 4L * THREADS * ((h + pick_nb(h) - 1) / pick_nb(h));
  return f + te;
}

// A tile's bytes on the tensor cores: the forward's A [max(K, H)] (m, then h2) and B [H] (h1);
// the backward's A (m, then g_h1), B (h1, then g_h2), G [Fo] (g_e') and two mask words a thread
// and column block; each [TC_TE][width + 8] bf16; then TC_TE edge ids.
WIDE_HD inline long tc_tile_bytes(int k, int h, int fo, bool backward) {
  long rows = (long)(k > h ? k : h) + 8 + h + 8;
  if (backward) rows += fo + 8;
  long bytes = rows * TC_TE * 2;
  if (backward) bytes += 2L * THREADS * 8 * ((h + pick_nb(h) - 1) / pick_nb(h));
  return bytes + TC_TE * 4;
}

// weight-gradient values, packed as w1 [h][k], b1 [h], w2 [h][h], b2 [h], w3 [fo][h], b3 [fo]
WIDE_HD inline long grad_floats(int k, int h, int fo) {
  return (long)h * k + h + (long)h * h + h + (long)fo * h + fo;
}

inline long cdiv(long a, long b) { return (a + b - 1) / b; }
inline long lmin(long a, long b) { return a < b ? a : b; }
inline long lmax(long a, long b) { return a > b ? a : b; }

// The plan, in the order fused_relational_wide_plan writes it:
//  * tc: the bf16 tensor-core route (bf16, every width a multiple of 32, tiles and ring within
//    the opt-in shared memory; te = TC_TE); else the CUDA cores with te edges a tile, the largest
//    of TILE_EDGES whose tiles and ring fit, else DEVICE_TE with the tiles in device memory,
//    device_tile_floats floats a block;
//  * smem, a block's shared-memory bytes, and blocks, one an SM and at most one a tile;
//  * the backward's chunks: chunk_tiles tiles a chunk (about as many whole `waves` of sms tiles
//    as keep its factor rows, factor_elems elements of the input dtype, under FACTOR_CAP bytes,
//    or all the tiles), n_chunks of them (enough for every edge unmasked), and the weight
//    gradients' slices a chunk of slice_tiles tiles (slices slice_tiles = chunk_tiles; one wave
//    of weight-gradient blocks, two an SM), one partial of grad_floats floats a slice
//    (partial_floats in all). Zero in the forward.
struct Plan {
  long te, tc, smem, device_tile_floats, blocks, waves, chunk_tiles, n_chunks, slices, slice_tiles,
      factor_elems, grad_floats, partial_floats;
};

inline Plan make_plan(int fx, int fe, int h, int fo, bool backward, bool bf16, long n_edges,
                      long optin, long sms) {
  Plan p{};
  const int k = 2 * fx + fe;
  const long tc_smem = TC_RING_BYTES + tc_tile_bytes(k, h, fo, backward);
  if (bf16 && fx % 32 == 0 && fe % 32 == 0 && h % 32 == 0 && fo % 32 == 0 && tc_smem <= optin) {
    p.te = TC_TE;
    p.tc = 1;
    p.smem = tc_smem;
  } else {
    p.te = DEVICE_TE;
    p.smem = 4L * RING_FLOATS;
    p.device_tile_floats = tile_floats(k, h, fo, backward, DEVICE_TE);
    for (int te : TILE_EDGES) {
      const long smem = 4L * (RING_FLOATS + tile_floats(k, h, fo, backward, te));
      if (smem <= optin) {
        p.te = te;
        p.smem = smem;
        p.device_tile_floats = 0;
        break;
      }
    }
  }
  const long n_tiles = lmax(1, cdiv(n_edges, p.te));
  p.blocks = lmin(sms, n_tiles);
  if (!backward) return p;
  // factor elements an edge: m (padded to 8), h1, h2, g_h2, g_h1, g_e'
  const long row = padded_k(k) + 4L * h + fo;
  p.waves = lmax(1, FACTOR_CAP / (p.te * row * (bf16 ? 2 : 4) * sms));
  const long dw_tiles =
      cdiv(h, BT) * cdiv(k, BT) + cdiv(h, BT) * cdiv(h, BT) + cdiv(fo, BT) * cdiv(h, BT);
  // slices a chunk: one wave of weight-gradient blocks, two an SM, as full as it gets
  p.slices = lmin(n_tiles, lmax(1, 2 * sms / dw_tiles));
  if (n_tiles <= p.waves * sms) {  // one chunk of whole slices
    p.slice_tiles = cdiv(n_tiles, p.slices);
    p.slices = cdiv(n_tiles, p.slice_tiles);
  } else {  // chunks of about `waves` waves of tiles, whole slices
    p.slice_tiles = lmax(1, p.waves * sms / p.slices);
  }
  p.chunk_tiles = p.slices * p.slice_tiles;
  p.n_chunks = cdiv(n_tiles, p.chunk_tiles);
  p.factor_elems = p.chunk_tiles * p.te * row;
  p.grad_floats = grad_floats(k, h, fo);
  p.partial_floats = p.n_chunks * p.slices * p.grad_floats;
  return p;
}

}  // namespace wide_plan

extern "C" {

// The wide layout's plan at widths (Fx, Fe, H, Fo) for n_edges edges on a card with `optin`
// bytes of shared memory a block and `sms` SMs, written to out [13] in Plan's order. Returns 0,
// or 1 (cudaErrorInvalidValue) where H or Fo is not a multiple of 4 or there is no SM.
int fused_relational_wide_plan(int fx, int fe, int h, int fo, int backward, int bf16, int n_edges,
                               int optin, int sms, long* out) {
  if (h % 4 || fo % 4 || sms < 1 || n_edges < 0) return 1;
  const wide_plan::Plan p =
      wide_plan::make_plan(fx, fe, h, fo, backward != 0, bf16 != 0, n_edges, optin, sms);
  const long values[] = {p.te,     p.tc,          p.smem,         p.device_tile_floats,
                         p.blocks, p.waves,       p.chunk_tiles,  p.n_chunks,
                         p.slices, p.slice_tiles, p.factor_elems, p.grad_floats,
                         p.partial_floats};
  for (int i = 0; i < 13; ++i) out[i] = values[i];
  return 0;
}

}  // extern "C"
