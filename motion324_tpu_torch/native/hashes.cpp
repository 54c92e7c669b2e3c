// Non-cryptographic 128-bit hashes used by the Alembic writer
// (motion324_tpu_torch/io/abc.py), the port's copy of the JAX package's
// motion324_tpu/native/hashes.cpp.
//
// MurmurHash3_x64_128: the hash Alembic >= 1.5 uses for array/scalar sample
// keys (reference consumer: Alembic's AbcCoreAbstract ArraySample::getKey,
// seeded with the POD byte size; the reference repo exports .abc via
// bpy.ops.wm.alembic_export, utils/render.py:158-163). Implemented from the
// public-domain algorithm (Austin Appleby); validated against the canonical
// implementation vendored by scikit-learn (sklearn/utils/src/MurmurHash3.cpp)
// in tests/test_hashes.py golden vectors.
//
// SpookyHash V2 (Bob Jenkins, public domain): Alembic's AbcCoreOgawa uses it
// to build the per-object 32-byte [properties-hash | children-hash] trailer.
// Implemented from the published algorithm; it is held against the numpy
// transcription in native/__init__.py (spooky_hash128_numpy), written
// independently, over every length regime.

#include <cstdint>
#include <cstring>

static inline uint64_t rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

// --------------------------------------------------------------------------
// MurmurHash3_x64_128
// --------------------------------------------------------------------------
static inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

extern "C" int murmur3_x64_128(const uint8_t* data, uint64_t len,
                               uint32_t seed, uint64_t* out) {
  const uint64_t nblocks = len / 16;
  uint64_t h1 = seed, h2 = seed;
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;

  for (uint64_t i = 0; i < nblocks; i++) {
    uint64_t k1, k2;
    memcpy(&k1, data + i * 16, 8);
    memcpy(&k2, data + i * 16 + 8, 8);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }

  const uint8_t* tail = data + nblocks * 16;
  uint64_t k1 = 0, k2 = 0;
  switch (len & 15) {
    case 15: k2 ^= ((uint64_t)tail[14]) << 48; [[fallthrough]];
    case 14: k2 ^= ((uint64_t)tail[13]) << 40; [[fallthrough]];
    case 13: k2 ^= ((uint64_t)tail[12]) << 32; [[fallthrough]];
    case 12: k2 ^= ((uint64_t)tail[11]) << 24; [[fallthrough]];
    case 11: k2 ^= ((uint64_t)tail[10]) << 16; [[fallthrough]];
    case 10: k2 ^= ((uint64_t)tail[9]) << 8; [[fallthrough]];
    case 9:  k2 ^= ((uint64_t)tail[8]);
             k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
             [[fallthrough]];
    case 8:  k1 ^= ((uint64_t)tail[7]) << 56; [[fallthrough]];
    case 7:  k1 ^= ((uint64_t)tail[6]) << 48; [[fallthrough]];
    case 6:  k1 ^= ((uint64_t)tail[5]) << 40; [[fallthrough]];
    case 5:  k1 ^= ((uint64_t)tail[4]) << 32; [[fallthrough]];
    case 4:  k1 ^= ((uint64_t)tail[3]) << 24; [[fallthrough]];
    case 3:  k1 ^= ((uint64_t)tail[2]) << 16; [[fallthrough]];
    case 2:  k1 ^= ((uint64_t)tail[1]) << 8; [[fallthrough]];
    case 1:  k1 ^= ((uint64_t)tail[0]);
             k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }

  h1 ^= len; h2 ^= len;
  h1 += h2; h2 += h1;
  h1 = fmix64(h1); h2 = fmix64(h2);
  h1 += h2; h2 += h1;
  out[0] = h1; out[1] = h2;
  return 0;
}

// --------------------------------------------------------------------------
// SpookyHash V2 (128-bit, one-shot)
// --------------------------------------------------------------------------
static const uint64_t SC_CONST = 0xdeadbeefdeadbeefULL;
static const int SC_NUMVARS = 12;
static const int SC_BLOCKSIZE = SC_NUMVARS * 8;  // 96
static const int SC_BUFSIZE = 2 * SC_BLOCKSIZE;  // 192

static inline void short_mix(uint64_t& h0, uint64_t& h1, uint64_t& h2,
                             uint64_t& h3) {
  h2 = rotl64(h2, 50); h2 += h3; h0 ^= h2;
  h3 = rotl64(h3, 52); h3 += h0; h1 ^= h3;
  h0 = rotl64(h0, 30); h0 += h1; h2 ^= h0;
  h1 = rotl64(h1, 41); h1 += h2; h3 ^= h1;
  h2 = rotl64(h2, 54); h2 += h3; h0 ^= h2;
  h3 = rotl64(h3, 48); h3 += h0; h1 ^= h3;
  h0 = rotl64(h0, 38); h0 += h1; h2 ^= h0;
  h1 = rotl64(h1, 37); h1 += h2; h3 ^= h1;
  h2 = rotl64(h2, 62); h2 += h3; h0 ^= h2;
  h3 = rotl64(h3, 34); h3 += h0; h1 ^= h3;
  h0 = rotl64(h0, 5);  h0 += h1; h2 ^= h0;
  h1 = rotl64(h1, 36); h1 += h2; h3 ^= h1;
}

static inline void short_end(uint64_t& h0, uint64_t& h1, uint64_t& h2,
                             uint64_t& h3) {
  h3 ^= h2; h2 = rotl64(h2, 15); h3 += h2;
  h0 ^= h3; h3 = rotl64(h3, 52); h0 += h3;
  h1 ^= h0; h0 = rotl64(h0, 26); h1 += h0;
  h2 ^= h1; h1 = rotl64(h1, 51); h2 += h1;
  h3 ^= h2; h2 = rotl64(h2, 28); h3 += h2;
  h0 ^= h3; h3 = rotl64(h3, 9);  h0 += h3;
  h1 ^= h0; h0 = rotl64(h0, 47); h1 += h0;
  h2 ^= h1; h1 = rotl64(h1, 54); h2 += h1;
  h3 ^= h2; h2 = rotl64(h2, 32); h3 += h2;
  h0 ^= h3; h3 = rotl64(h3, 25); h0 += h3;
  h1 ^= h0; h0 = rotl64(h0, 63); h1 += h0;
}

static void spooky_short(const uint8_t* data, uint64_t len, uint64_t* hash1,
                         uint64_t* hash2) {
  uint64_t buf[2 * SC_NUMVARS];
  uint64_t remainder = len % 32;
  uint64_t a = *hash1, b = *hash2, c = SC_CONST, d = SC_CONST;
  const uint8_t* p = data;

  if (len > 15) {
    const uint8_t* end = data + (len / 32) * 32;
    for (; p < end; p += 32) {
      uint64_t w[4];
      memcpy(w, p, 32);
      c += w[0]; d += w[1];
      short_mix(a, b, c, d);
      a += w[2]; b += w[3];
    }
    if (remainder >= 16) {
      uint64_t w[2];
      memcpy(w, p, 16);
      c += w[0]; d += w[1];
      short_mix(a, b, c, d);
      p += 16;
      remainder -= 16;
    }
  }

  d += len << 56;
  memset(buf, 0, sizeof(uint64_t) * 2);
  memcpy(buf, p, remainder);
  const uint8_t* rb = (const uint8_t*)buf;
  switch (remainder) {
    case 15: d += ((uint64_t)rb[14]) << 48; [[fallthrough]];
    case 14: d += ((uint64_t)rb[13]) << 40; [[fallthrough]];
    case 13: d += ((uint64_t)rb[12]) << 32; [[fallthrough]];
    case 12: { uint32_t w; memcpy(&w, rb + 8, 4); d += w;
               uint64_t w2; memcpy(&w2, rb, 8); c += w2; break; }
    case 11: d += ((uint64_t)rb[10]) << 16; [[fallthrough]];
    case 10: d += ((uint64_t)rb[9]) << 8; [[fallthrough]];
    case 9:  d += (uint64_t)rb[8]; [[fallthrough]];
    case 8:  { uint64_t w; memcpy(&w, rb, 8); c += w; break; }
    case 7:  c += ((uint64_t)rb[6]) << 48; [[fallthrough]];
    case 6:  c += ((uint64_t)rb[5]) << 40; [[fallthrough]];
    case 5:  c += ((uint64_t)rb[4]) << 32; [[fallthrough]];
    case 4:  { uint32_t w; memcpy(&w, rb, 4); c += w; break; }
    case 3:  c += ((uint64_t)rb[2]) << 16; [[fallthrough]];
    case 2:  c += ((uint64_t)rb[1]) << 8; [[fallthrough]];
    case 1:  c += (uint64_t)rb[0]; break;
    case 0:  c += SC_CONST; d += SC_CONST; break;
  }
  short_end(a, b, c, d);
  *hash1 = a;
  *hash2 = b;
}

static inline void spooky_mix(const uint64_t* data, uint64_t* s) {
  s[0] += data[0];  s[2] ^= s[10]; s[11] ^= s[0];  s[0] = rotl64(s[0], 11);  s[11] += s[1];
  s[1] += data[1];  s[3] ^= s[11]; s[0] ^= s[1];   s[1] = rotl64(s[1], 32);  s[0] += s[2];
  s[2] += data[2];  s[4] ^= s[0];  s[1] ^= s[2];   s[2] = rotl64(s[2], 43);  s[1] += s[3];
  s[3] += data[3];  s[5] ^= s[1];  s[2] ^= s[3];   s[3] = rotl64(s[3], 31);  s[2] += s[4];
  s[4] += data[4];  s[6] ^= s[2];  s[3] ^= s[4];   s[4] = rotl64(s[4], 17);  s[3] += s[5];
  s[5] += data[5];  s[7] ^= s[3];  s[4] ^= s[5];   s[5] = rotl64(s[5], 28);  s[4] += s[6];
  s[6] += data[6];  s[8] ^= s[4];  s[5] ^= s[6];   s[6] = rotl64(s[6], 39);  s[5] += s[7];
  s[7] += data[7];  s[9] ^= s[5];  s[6] ^= s[7];   s[7] = rotl64(s[7], 57);  s[6] += s[8];
  s[8] += data[8];  s[10] ^= s[6]; s[7] ^= s[8];   s[8] = rotl64(s[8], 55);  s[7] += s[9];
  s[9] += data[9];  s[11] ^= s[7]; s[8] ^= s[9];   s[9] = rotl64(s[9], 54);  s[8] += s[10];
  s[10] += data[10]; s[0] ^= s[8]; s[9] ^= s[10];  s[10] = rotl64(s[10], 22); s[9] += s[11];
  s[11] += data[11]; s[1] ^= s[9]; s[10] ^= s[11]; s[11] = rotl64(s[11], 46); s[10] += s[0];
}

static inline void end_partial(uint64_t* h) {
  h[11] += h[1]; h[2] ^= h[11]; h[1] = rotl64(h[1], 44);
  h[0] += h[2];  h[3] ^= h[0];  h[2] = rotl64(h[2], 15);
  h[1] += h[3];  h[4] ^= h[1];  h[3] = rotl64(h[3], 34);
  h[2] += h[4];  h[5] ^= h[2];  h[4] = rotl64(h[4], 21);
  h[3] += h[5];  h[6] ^= h[3];  h[5] = rotl64(h[5], 38);
  h[4] += h[6];  h[7] ^= h[4];  h[6] = rotl64(h[6], 33);
  h[5] += h[7];  h[8] ^= h[5];  h[7] = rotl64(h[7], 10);
  h[6] += h[8];  h[9] ^= h[6];  h[8] = rotl64(h[8], 13);
  h[7] += h[9];  h[10] ^= h[7]; h[9] = rotl64(h[9], 38);
  h[8] += h[10]; h[11] ^= h[8]; h[10] = rotl64(h[10], 53);
  h[9] += h[11]; h[0] ^= h[9];  h[11] = rotl64(h[11], 42);
  h[10] += h[0]; h[1] ^= h[10]; h[0] = rotl64(h[0], 54);
}

static inline void spooky_end(const uint64_t* data, uint64_t* h) {
  for (int i = 0; i < SC_NUMVARS; i++) h[i] += data[i];
  end_partial(h);
  end_partial(h);
  end_partial(h);
}

extern "C" int spooky_hash128(const uint8_t* data, uint64_t len,
                              uint64_t seed1, uint64_t seed2, uint64_t* out) {
  if (len < (uint64_t)SC_BUFSIZE) {
    uint64_t h1 = seed1, h2 = seed2;
    spooky_short(data, len, &h1, &h2);
    out[0] = h1; out[1] = h2;
    return 0;
  }
  uint64_t h[SC_NUMVARS];
  h[0] = h[3] = h[6] = h[9] = seed1;
  h[1] = h[4] = h[7] = h[10] = seed2;
  h[2] = h[5] = h[8] = h[11] = SC_CONST;

  uint64_t nblocks = len / SC_BLOCKSIZE;
  const uint8_t* p = data;
  uint64_t block[SC_NUMVARS];
  for (uint64_t i = 0; i < nblocks; i++, p += SC_BLOCKSIZE) {
    memcpy(block, p, SC_BLOCKSIZE);
    spooky_mix(block, h);
  }
  uint64_t remainder = len - nblocks * (uint64_t)SC_BLOCKSIZE;
  memset(block, 0, SC_BLOCKSIZE);
  memcpy(block, p, remainder);
  ((uint8_t*)block)[SC_BLOCKSIZE - 1] = (uint8_t)remainder;
  spooky_end(block, h);
  out[0] = h[0]; out[1] = h[1];
  return 0;
}
