// The tiles of the wgmma routes (the flash forward's `flash_fwd_wgmma`
// in flash_attention.cu, the backward's passes in flash_attention_bwd.cu,
// paged attention's `paged_chunk` in paged_attention.cu): the
// shared-memory layout of a [64][HD] bf16 tile and where a gathered
// row's chunks go in it, its wgmma descriptors, the product over HD with
// the tile read MN-major, its TMA loads, and the host-side 4-D tensor
// maps that feed them.
//
// A tile comes as HD / 64 wide boxes of [64 rows][64 columns] (128-byte
// rows, 128-byte swizzle), then the rest, R = HD % 64 columns (16 or 32),
// as one box of R columns at the 32- or 64-byte swizzle: hd 64 and 128
// are one and two wide boxes, hd 80 a wide box and 16 columns (a product
// over N = 80 is one over each box into one accumulator), hd 16 and 32
// the rest alone.  The maps are 4-D, (hd, heads, rows, batch), read in
// boxes of one head x 64 rows, so a strided operand (a ring slice
// ring[:, :S], a stacked cache's superblock) is read in place and rows
// past the operand's end arrive as zeros.

#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace tc {

constexpr int kRows = 64;          // rows of a tile: a wgmma's M, a box's rows

template <int HD>
struct Tile {
  static constexpr int kWide = HD / 64;
  static constexpr int R = HD % 64;
  static constexpr int kWideBox = kRows * 128;
  static constexpr int kRestW = 2 * R;              // bytes a rest row
  static constexpr uint32_t kRestLayout = R == 32 ? 2 : 3;
  static constexpr int kBytes = kRows * HD * 2;
  // Ring slots per warpgroup of the backward: three tiles in flight below
  // hd 128, two at hd 128 (shared memory).
  static constexpr int kSlots = HD >= 128 ? 2 : 3;
  static_assert(R == 0 || R == 16 || R == 32, "head_dim 16/32/64/80/128");
  static_assert(kBytes % 1024 == 0, "tiles keep 1024-byte alignment");
};

// The tensor maps of one operand: its wide boxes and its rest (either
// unused where the head_dim has none).
struct OperandMaps {
  CUtensorMap wide, rest;
};

// Descriptor of k-step kk of a tile used K-major (the product's k along
// HD): 16 columns are 32 bytes into a box row, or the next box.
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using L = Tile<HD>;
  const int col = 16 * kk;
  if (col < 64 * L::kWide)
    return hopper::smem_desc(tile + col / 64 * L::kWideBox + col % 64 * 2,
                             16, 1024, 1);
  return hopper::smem_desc(
      tile + L::kWide * L::kWideBox + (col - 64 * L::kWide) * 2, 16,
      8 * L::kRestW, L::kRestLayout);
}

// Byte offset in a tile of the 16-byte chunk `ch` (columns 8 ch ..
// 8 ch + 7) of row `row`, where TMA's swizzle puts it: within each box,
// address bits 4.. (the chunk within a 128-, 64- or 32-byte row span)
// XOR bits 7.. (3, 2 or 1 of them), the box bases 1024-aligned.  A tile
// gathered row by row (cp.async) into these offsets is the tile TMA
// writes, for the same descriptors.
template <int HD>
__device__ __forceinline__ int swizzled(int row, int ch) {
  using L = Tile<HD>;
  const int col = 8 * ch;
  if (col < 64 * L::kWide)
    return (col / 64 * L::kWideBox + row * 128 + col % 64 * 2) ^
           ((row & 7) << 4);
  const int off =
      L::kWide * L::kWideBox + row * L::kRestW + (col - 64 * L::kWide) * 2;
  return off ^ (((off >> 7) & (L::R == 32 ? 3 : 1)) << 4);
}

// acc[64 x HD] += a[64 x 16] * tile[16 rows kk.. of 64][HD], the tile read
// MN-major (trans-b): one product over the wide boxes (the next box along
// N is the leading byte offset away), one over the rest.
template <int HD>
__device__ __forceinline__ void mma_mn(float (&acc)[HD / 2],
                                       const uint32_t (&a)[4], uint32_t tile,
                                       int kk) {
  using L = Tile<HD>;
  if constexpr (L::kWide > 0)
    hopper::Wgmma<64 * L::kWide>::template rs<1, 0>(
        acc, a, hopper::smem_desc(tile + kk * 16 * 128, L::kWideBox, 1024, 1),
        1);
  if constexpr (L::R > 0)
    hopper::Wgmma<L::R>::template rs<1, 32 * L::kWide>(
        acc, a,
        hopper::smem_desc(tile + L::kWide * L::kWideBox + kk * 16 * L::kRestW,
                          kRows * L::kRestW, 8 * L::kRestW, L::kRestLayout),
        1);
}

// TMA of rows row .. row + 63 of one head: every box of the tile.
template <int HD>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const OperandMaps& maps, int head,
                                          int row, int b, uint64_t* bar) {
  using L = Tile<HD>;
#pragma unroll
  for (int i = 0; i < L::kWide; ++i)
    hopper::tma_load_4d(dst + i * L::kWideBox, &maps.wide, 64 * i, head, row,
                        b, bar);
  if constexpr (L::R > 0)
    hopper::tma_load_4d(dst + L::kWide * L::kWideBox, &maps.rest,
                        64 * L::kWide, head, row, b, bar);
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// tanh(x) = 1 - 2 / (2^(2 x log2 e) + 1) by ex2.approx and a fast
// division: about 1e-6 absolute error, saturating to +-1 (2^+-inf), in far
// fewer registers than tanhf.
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.f - __fdividef(2.f, flash::fast_exp2(x * (2.f * flash::kLog2e)) +
                                   1.f);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
}

// A 4-D tensor map of a [B, rows, heads, HD] bf16 operand with element
// strides st (batch, sequence, head) and a unit head_dim stride, over
// (HD, heads, rows, B), read in boxes of one head x 64 rows x `cols`
// columns at swizzle `sw`.  Rows past `rows` arrive as zeros; the strides
// must be 16-byte multiples (a dimension of size 1 takes any).
inline bool tile_map(CUtensorMap* map, const void* base, int hd, int B,
                     int rows, int heads, const long long (&st)[3], int cols,
                     CUtensorMapSwizzle sw) {
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const long long sizes[3] = {heads, rows, B};
  const long long elems[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const long long bytes = elems[i] * 2;
    if (bytes <= 0 || bytes % 16) {
      if (sizes[i] > 1) return false;
      strides[i] = 16;
    } else {
      strides[i] = (cuuint64_t)bytes;
    }
  }
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of one operand for the boxes of Tile<HD>.
template <int HD>
bool operand_maps(OperandMaps* m, const void* base, int B, int rows,
                  int heads, const long long (&st)[3]) {
  using L = Tile<HD>;
  if (L::kWide > 0 && !tile_map(&m->wide, base, HD, B, rows, heads, st, 64,
                                CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  return L::R == 0 ||
         tile_map(&m->rest, base, HD, B, rows, heads, st, L::R,
                  L::R == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace tc
