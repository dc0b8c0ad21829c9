"""Elias-Gamma pointer-array compression + resident indexes (paper §4.2.1, §8.4).

The paper pins the pointer-array in RAM by delta-encoding the (vertex-ID,
offset) increasing sequences with Elias-Gamma codes — reported 424 MB vs
3,383 MB raw on twitter-2010, 26x faster out-edge queries. Since the disk
tier landed, this codec sits on the REAL read path: partition files store
their pointer arrays gamma-compressed, `DiskPartition` keeps only the
compressed blobs pinned and decodes on demand, and `GammaChunkedIndex` is
the paper's chunked-decode lookup structure compared against the raw and
sparse on-disk indexes in `benchmarks/bench_disk.py` (Figure 8c).

Both codec directions are bit-parallel numpy: encode scatters every code's
bits with one fancy-index write; decode finds the code boundaries by
pointer-doubling over a next-one jump table (log₂(#codes) vectorized
passes) and extracts all values with one reduceat. The original per-value
Python loops are kept as `elias_gamma_encode_ref`/`elias_gamma_decode_ref`
and the tests assert the vectorized versions are bitwise identical.

Host copy of the reference `repro/core/codec.py` (numpy): the same bits.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import telemetry

_M_BLOCK_READS = telemetry.counter("codec.block_reads")
_M_CHUNK_DECODES = telemetry.counter("codec.chunk_decodes")
_M_BLOCK_DECODES = telemetry.counter("codec.block_decodes")

__all__ = [
    "elias_gamma_encode",
    "elias_gamma_decode",
    "elias_gamma_encode_ref",
    "elias_gamma_decode_ref",
    "encode_monotonic",
    "decode_monotonic",
    "encode_monotonic_blocked",
    "decode_monotonic_blocked",
    "SparseIndex",
    "GammaChunkedIndex",
]


def _bit_length(x: np.ndarray) -> np.ndarray:
    """floor(log2(x)) + 1 for x >= 1, vectorized."""
    return np.floor(np.log2(x.astype(np.float64))).astype(np.int64) + 1


# ---------------------------------------------------------------------------
# Reference (per-value / per-bit) implementations — kept for the bitwise-
# identity tests; never on a hot path.
# ---------------------------------------------------------------------------
def elias_gamma_encode_ref(values: np.ndarray) -> Tuple[np.ndarray, int]:
    values = np.asarray(values, dtype=np.int64)
    if values.size == 0:
        return np.empty(0, np.uint8), 0
    if (values < 1).any():
        raise ValueError("Elias-Gamma requires values >= 1")
    nlens = _bit_length(values)
    total_bits = int((2 * nlens - 1).sum())
    bits = np.zeros(total_bits, dtype=np.uint8)
    code_lens = 2 * nlens - 1
    starts = np.concatenate([[0], np.cumsum(code_lens)[:-1]])
    for i in range(values.shape[0]):
        v, n, s = int(values[i]), int(nlens[i]), int(starts[i])
        for b in range(n):
            bits[s + n - 1 + b] = (v >> (n - 1 - b)) & 1
    return np.packbits(bits), total_bits


def elias_gamma_decode_ref(packed: np.ndarray, nbits: int) -> np.ndarray:
    bits = np.unpackbits(np.asarray(packed, np.uint8))[:nbits]
    out = []
    i = 0
    while i < nbits:
        n = 0
        while bits[i] == 0:
            n += 1
            i += 1
        v = 0
        for _ in range(n + 1):
            v = (v << 1) | int(bits[i])
            i += 1
        out.append(v)
    return np.asarray(out, dtype=np.int64)


# ---------------------------------------------------------------------------
# Bit-parallel implementations (the real read/write path)
# ---------------------------------------------------------------------------
def elias_gamma_encode(values: np.ndarray) -> Tuple[np.ndarray, int]:
    """Encode positive integers with Elias-Gamma: N-1 zeros then the N-bit
    binary of the value (N = bit length). Returns (packed uint8 array, nbits).
    Bitwise identical to `elias_gamma_encode_ref`, no per-value loop."""
    values = np.asarray(values, dtype=np.int64)
    if values.size == 0:
        return np.empty(0, np.uint8), 0
    if (values < 1).any():
        raise ValueError("Elias-Gamma requires values >= 1")
    nlens = _bit_length(values)
    code_lens = 2 * nlens - 1
    total_bits = int(code_lens.sum())
    starts = np.cumsum(code_lens) - code_lens  # code start bit per value
    # one flat index over every explicit (binary-part) bit of every code
    T = int(nlens.sum())
    ids = np.repeat(np.arange(values.shape[0], dtype=np.int64), nlens)
    b = np.arange(T, dtype=np.int64) - np.repeat(np.cumsum(nlens) - nlens, nlens)
    bits = np.zeros(total_bits, dtype=np.uint8)
    bits[starts[ids] + nlens[ids] - 1 + b] = (
        (values[ids] >> (nlens[ids] - 1 - b)) & 1
    ).astype(np.uint8)
    return np.packbits(bits), total_bits


def elias_gamma_decode(packed: np.ndarray, nbits: int) -> np.ndarray:
    """Decode an Elias-Gamma stream without a per-code Python loop.

    A code starting at bit s has its leading one at o = next-one(s) and ends
    at 2o - s + 1, so code starts are the orbit of 0 under the jump
    step(s) = 2·nxt1(s) - s + 1. The orbit is enumerated by pointer
    doubling — starts of the first 2^k codes plus the 2^k-fold composed
    jump table give the first 2^(k+1) — in log₂(#codes) vectorized passes;
    values are then extracted with one ragged reduceat."""
    if nbits == 0:
        return np.empty(0, np.int64)
    bits = np.unpackbits(np.asarray(packed, np.uint8), count=nbits)
    if not bits.any():
        raise ValueError("malformed Elias-Gamma stream: no set bits")
    N = int(nbits)
    nxt = _next_one_table(bits)
    pos = np.arange(N, dtype=np.int64)
    step = np.minimum(2 * nxt[:N] - pos + 1, N)  # N = absorbing "done" state
    step = np.append(step, N)
    starts = np.zeros(1, np.int64)
    jump = step
    while starts[-1] < N:
        starts = np.concatenate([starts, jump[starts]])
        if starts[-1] >= N:
            break
        jump = jump[jump]
    starts = starts[starts < N]
    return _extract_values(bits, starts, nxt)


def _next_one_table(bits: np.ndarray) -> np.ndarray:
    """nxt[i] = smallest j >= i with bits[j] == 1, else N; domain [0, N].
    One reverse minimum-accumulate pass, no binary searches."""
    N = int(bits.shape[0])
    arr = np.full(N + 1, N, np.int64)
    ones = np.flatnonzero(bits)
    arr[ones] = ones
    arr[:N] = np.minimum.accumulate(arr[N - 1::-1])[::-1]
    return arr


def _extract_values(bits: np.ndarray, starts: np.ndarray,
                    nxt: np.ndarray) -> np.ndarray:
    o = nxt[starts]                             # leading one per code
    return _extract_ragged(bits, o, o - starts)


def _extract_ragged(bits: np.ndarray, o: np.ndarray,
                    z: np.ndarray) -> np.ndarray:
    """Values of codes with leading ones `o` and zero-prefix lengths `z`:
    one ragged gather + shift + reduceat, no per-code loop. Handles any
    code length (the word-window fast path below caps at 57 bits)."""
    lens = z + 1                                # explicit binary-part length
    offs = np.cumsum(lens) - lens
    T = int(offs[-1] + lens[-1])
    b = np.arange(T, dtype=np.int64) - np.repeat(offs, lens)
    contrib = bits[np.repeat(o, lens) + b].astype(np.int64) << (np.repeat(z, lens) - b)
    return np.add.reduceat(contrib, offs)


def _extract_words(packed: np.ndarray, o: np.ndarray,
                   z: np.ndarray) -> np.ndarray:
    """Values of codes with leading ones `o` and zero-prefix lengths `z`,
    read straight out of the PACKED bytes: gather one unaligned 64-bit
    big-endian window per code, shift, mask. Requires every binary part to
    fit a window at any bit offset: z + 1 <= 57."""
    B = np.concatenate([np.asarray(packed, np.uint8), np.zeros(8, np.uint8)])
    byte0 = o >> 3
    w = np.zeros(o.shape[0], np.uint64)
    for k in range(8):
        w = (w << np.uint64(8)) | B[byte0 + k].astype(np.uint64)
    lens = (z + 1).astype(np.uint64)
    shift = np.uint64(64) - (o & 7).astype(np.uint64) - lens
    return ((w >> shift) & ((np.uint64(1) << lens) - np.uint64(1))).astype(np.int64)


def encode_monotonic(seq: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """Delta + Elias-Gamma for a non-decreasing sequence (pointer-array).
    Returns (packed, nbits, first_value). Deltas are stored +1 (gamma needs >=1)."""
    seq = np.asarray(seq, dtype=np.int64)
    if seq.size == 0:
        return np.empty(0, np.uint8), 0, 0
    deltas = np.diff(seq) + 1
    packed, nbits = elias_gamma_encode(deltas)
    return packed, nbits, int(seq[0])


def decode_monotonic(packed: np.ndarray, nbits: int, first: int,
                     n: int) -> np.ndarray:
    if n == 0:
        return np.empty(0, np.int64)
    if n == 1:
        return np.asarray([first], np.int64)
    deltas = elias_gamma_decode(packed, nbits) - 1
    return np.concatenate([[first], first + np.cumsum(deltas)])


#: Codes per block in the blocked monotonic format — the sequential-
#: dependency length of blocked decode (one int64 bit-offset of directory
#: per block ≈ 1 bit/value overhead at 64).
GAMMA_BLOCK = 64


def encode_monotonic_blocked(
    seq: np.ndarray, block: int = GAMMA_BLOCK,
) -> Tuple[np.ndarray, int, int, np.ndarray]:
    """Delta + Elias-Gamma with a bit-offset directory every `block` codes.

    Returns (packed, nbits, first_value, offsets). The bit stream is
    IDENTICAL to `encode_monotonic`; the directory (`offsets[j]` = bit
    offset of delta j*block) is what lets `decode_monotonic_blocked` find
    code boundaries with only `block` sequential steps, vectorized across
    all blocks — this is the disk tier's resident-index format.
    """
    seq = np.asarray(seq, dtype=np.int64)
    if seq.size == 0:
        return np.empty(0, np.uint8), 0, 0, np.empty(0, np.int64)
    deltas = np.diff(seq) + 1
    if deltas.size == 0:
        return np.empty(0, np.uint8), 0, int(seq[0]), np.empty(0, np.int64)
    if (deltas < 1).any():
        raise ValueError("sequence must be non-decreasing")
    nlens = _bit_length(deltas)
    code_lens = 2 * nlens - 1
    starts = np.cumsum(code_lens) - code_lens
    packed, nbits = elias_gamma_encode(deltas)
    return packed, nbits, int(seq[0]), starts[::block].copy()


def decode_monotonic_blocked(
    packed: np.ndarray, nbits: int, first: int, n: int,
    offsets: np.ndarray, block: int = GAMMA_BLOCK,
) -> np.ndarray:
    """Decode a blocked monotonic stream. Boundary discovery — the only
    sequentially-dependent part of gamma decoding — runs `block` (= 64)
    vector steps over ALL blocks at once instead of one step per code, so
    decode cost is O(nbits) + 64 small vector ops regardless of length."""
    if n == 0:
        return np.empty(0, np.int64)
    if n == 1:
        return np.asarray([first], np.int64)
    m = n - 1  # deltas
    packed = np.asarray(packed, np.uint8)
    bits = np.unpackbits(packed, count=nbits)
    ones = np.flatnonzero(bits).astype(np.int64)
    N = int(nbits)
    offsets = np.asarray(offsets, np.int64)
    C = offsets.shape[0]
    counts = np.full(C, block, np.int64)
    counts[-1] = m - block * (C - 1)
    nrounds = min(block, m)
    s = offsets.copy()
    starts_mat = np.empty((nrounds, C), np.int64)
    o_mat = np.empty((nrounds, C), np.int64)
    for t in range(nrounds):
        r = np.searchsorted(ones, s)
        valid = r < ones.shape[0]
        o = np.where(valid, ones[np.minimum(r, ones.shape[0] - 1)], N)
        starts_mat[t] = s
        o_mat[t] = o
        s = np.where(valid, 2 * o - s + 1, N)   # N absorbs finished blocks
    # block j's codes are column j, rows 0..counts[j)
    mask = np.arange(nrounds)[None, :] < counts[:, None]
    o = o_mat.T[mask]
    z = o - starts_mat.T[mask]
    deltas = (_extract_words(packed, o, z) if int(z.max()) <= 56
              else _extract_ragged(bits, o, z)) - 1
    return np.concatenate([[first], first + np.cumsum(deltas)])


def gamma_decode_block_deltas(packed: np.ndarray, nbits: int,
                              offsets: np.ndarray, blocks: np.ndarray,
                              m: int, block: int = GAMMA_BLOCK) -> np.ndarray:
    """Decode ONLY the selected blocks of a blocked monotonic stream.

    Returns a (len(blocks), block) int64 matrix of the raw (+1) deltas,
    padded with 1 past the stream end so a row cumsum of (delta - 1) is
    inert beyond the real values. This is the partial-decode primitive
    behind point lookups on the compressed resident index: a query touches
    ~one 64-code block instead of the whole pointer array."""
    blocks = np.asarray(blocks, np.int64)
    offsets = np.asarray(offsets, np.int64)
    B = blocks.shape[0]
    out = np.ones((B, block), np.int64)
    if B == 0 or m == 0:
        return out
    packed = np.asarray(packed, np.uint8)
    cnt_all = np.clip(m - blocks * block, 0, block)  # live deltas per block
    # the final VALUE block may hold zero deltas (n = k*block + 1): it has
    # no directory entry and decodes to nothing — keep only live blocks
    act = np.flatnonzero(cnt_all > 0)
    if act.size == 0:
        return out
    blocks, cnt = blocks[act], cnt_all[act]
    B = blocks.shape[0]
    rounds = int(cnt.max())
    # compact ONLY the selected blocks' bytes — decode cost is the bytes
    # the query touches, independent of the whole stream's length
    ends = np.append(offsets[1:], nbits)
    lo, hi = offsets[blocks], ends[blocks]
    byte_lo = lo >> 3
    byte_len = ((hi + 7) >> 3) - byte_lo
    base = np.cumsum(byte_len) - byte_len       # sub-buffer byte offset
    T = int(base[-1] + byte_len[-1])
    gidx = np.arange(T, dtype=np.int64) - np.repeat(base, byte_len) \
        + np.repeat(byte_lo, byte_len)
    sub = packed[gidx]
    bits = np.unpackbits(sub)
    ones = np.flatnonzero(bits).astype(np.int64)
    N = int(bits.shape[0])
    # each code's walk stays inside its own block's bit range, so the
    # per-block walks run in the shared sub-bit space without interfering
    s = base * 8 + (lo - byte_lo * 8)
    s_mat = np.empty((rounds, B), np.int64)
    o_mat = np.empty((rounds, B), np.int64)
    for t in range(rounds):
        r = np.searchsorted(ones, s)
        valid = r < ones.shape[0]
        o = np.where(valid, ones[np.minimum(r, ones.shape[0] - 1)], N)
        s_mat[t] = s
        o_mat[t] = o
        s = np.where(valid, 2 * o - s + 1, N)
    tmask = np.arange(rounds)[None, :] < cnt[:, None]
    o_sel = o_mat.T[tmask]
    z_sel = o_sel - s_mat.T[tmask]
    if o_sel.size:
        vals = (_extract_words(sub, o_sel, z_sel)
                if int(z_sel.max()) <= 56
                else _extract_ragged(bits, o_sel, z_sel))
        dec = np.ones((B, block), np.int64)
        dec[:, :rounds][tmask] = vals
        out[act] = dec  # scatter live rows back (delta-less rows stay 1s)
    return out


class BlockedGammaPointer:
    """A pointer array resident ONLY in compressed form: gamma blobs + a
    64-code bit-offset directory + the raw first VALUE of each block
    (1/64th of the data). Queries decode just the blocks they touch — the
    paper's chunked pointer-array design (§4.2.1) — so lookup cost is
    O(frontier), never O(index).

    `searchsorted`/`values_at` require the underlying array to be sorted
    (searchsorted additionally assumes strictly increasing keys, which
    holds for the vertex arrays it serves)."""

    _PAD = np.iinfo(np.int64).max

    def __init__(self, packed: np.ndarray, offsets: np.ndarray, nbits: int,
                 first: int, n: int, firsts: np.ndarray,
                 block: int = GAMMA_BLOCK):
        self.packed = np.asarray(packed, np.uint8)
        self.offsets = np.asarray(offsets, np.int64)
        self.nbits = int(nbits)
        self.first = int(first)
        self.n = int(n)
        self.firsts = np.asarray(firsts, np.int64)
        self.block = int(block)

    @classmethod
    def from_array(cls, arr: np.ndarray,
                   block: int = GAMMA_BLOCK) -> "BlockedGammaPointer":
        arr = np.asarray(arr, np.int64)
        packed, nbits, first, offsets = encode_monotonic_blocked(arr, block)
        return cls(packed, offsets, nbits, first, int(arr.shape[0]),
                   arr[::block].copy(), block)

    def nbytes(self) -> int:
        return self.packed.nbytes + self.offsets.nbytes + self.firsts.nbytes

    def _decode_blocks(self, blocks: np.ndarray) -> np.ndarray:
        """(len(blocks), block) matrix of VALUES, padded with int64 max."""
        K = self.block
        _M_BLOCK_DECODES.inc(int(blocks.shape[0]))
        deltas = gamma_decode_block_deltas(
            self.packed, self.nbits, self.offsets, blocks, self.n - 1, K)
        vals = np.empty((blocks.shape[0], K), np.int64)
        vals[:, 0] = self.firsts[blocks]
        np.cumsum(deltas[:, :-1] - 1, axis=1, out=deltas[:, :-1])
        vals[:, 1:] = vals[:, :1] + deltas[:, :-1]
        cnt_v = np.clip(self.n - blocks * K, 0, K)
        vals[np.arange(K)[None, :] >= cnt_v[:, None]] = self._PAD
        return vals

    def searchsorted(self, keys) -> np.ndarray:
        """np.searchsorted(decode_all(), keys, side='left'), decoding at
        most one block per distinct key."""
        return self.searchsorted_with_values(keys)[0]

    def searchsorted_with_values(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        """(insertion index, value AT that index) in one decode pass — the
        point-lookup primitive (find a vertex, check it exists). The value
        is arbitrary where the index lands past the end; callers mask with
        `idx < n`."""
        keys = np.asarray(keys, np.int64)
        if self.n == 0:
            z = np.zeros(keys.shape, np.int64)
            return z, z.copy()
        b = np.searchsorted(self.firsts, keys, side="right") - 1
        b = np.maximum(b, 0)
        ub = np.unique(b)
        mat = self._decode_blocks(ub)
        row = np.searchsorted(ub, b)
        K = self.block
        within = (mat[row] < keys[..., None]).sum(axis=-1)
        # within == K → the key lands at the NEXT block's first value,
        # which is resident in the directory — no second decode
        vals = np.where(
            within < K,
            np.take_along_axis(mat[row], np.minimum(within, K - 1)[..., None],
                               axis=-1)[..., 0],
            self.firsts[np.minimum(b + 1, self.firsts.shape[0] - 1)])
        return b * K + within, vals

    def values_at(self, idx) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        b = idx // self.block
        ub = np.unique(b)
        mat = self._decode_blocks(ub)
        return mat[np.searchsorted(ub, b), idx % self.block]

    def decode_all(self) -> np.ndarray:
        return decode_monotonic_blocked(self.packed, self.nbits, self.first,
                                        self.n, self.offsets, self.block)


class SparseIndex:
    """In-memory sparse index over an on-disk sorted array (paper §4.2.1,
    second option): every `stride`-th key is kept in RAM; a lookup consults
    the sparse index then reads one block — `keys` may be a live `np.memmap`
    so the block read is a real page fault, and the count reproduces
    Figure 8c."""

    def __init__(self, keys: np.ndarray, stride: int = 64):
        self.keys = np.asarray(keys)
        self.stride = stride
        self.sparse = np.array(self.keys[::stride])  # resident copy
        self.block_reads = 0

    def lookup(self, k) -> int:
        """Index of k in keys, or -1. One block read per lookup."""
        j = int(np.searchsorted(self.sparse, k, side="right")) - 1
        j = max(j, 0)
        lo = j * self.stride
        hi = min(lo + self.stride, self.keys.shape[0])
        self.block_reads += 1
        _M_BLOCK_READS.inc()
        i = lo + int(np.searchsorted(self.keys[lo:hi], k))
        if i < hi and self.keys[i] == k:
            return i
        return -1

    def nbytes(self) -> int:
        return self.sparse.nbytes


class GammaChunkedIndex:
    """The paper's third pointer-array option: the sorted key array lives in
    RAM *compressed*, split into fixed-size chunks each delta+Elias-Gamma
    coded. A lookup binary-searches the (small) chunk-first directory, then
    decodes exactly ONE chunk with the bit-parallel decoder — zero disk
    reads, compressed-size residency, CPU-for-RAM as in §8.4."""

    def __init__(self, keys: np.ndarray, chunk: int = 1024):
        keys = np.asarray(keys, dtype=np.int64)
        self.n = int(keys.shape[0])
        self.chunk = int(chunk)
        self.firsts = keys[::chunk].copy() if self.n else np.empty(0, np.int64)
        self.blobs: List[Tuple[np.ndarray, int, int, int]] = []
        for c in range(0, self.n, chunk):
            part = keys[c:c + chunk]
            packed, nbits, first = encode_monotonic(part)
            self.blobs.append((packed, nbits, first, int(part.shape[0])))
        self.chunk_decodes = 0

    def decode_chunk(self, j: int) -> np.ndarray:
        packed, nbits, first, n = self.blobs[j]
        self.chunk_decodes += 1
        _M_CHUNK_DECODES.inc()
        return decode_monotonic(packed, nbits, first, n)

    def decode_all(self) -> np.ndarray:
        if self.n == 0:
            return np.empty(0, np.int64)
        return np.concatenate([self.decode_chunk(j)
                               for j in range(len(self.blobs))])

    def lookup(self, k) -> int:
        """Index of k in the original array, or -1."""
        if self.n == 0:
            return -1
        j = int(np.searchsorted(self.firsts, k, side="right")) - 1
        j = max(j, 0)
        keys = self.decode_chunk(j)
        i = int(np.searchsorted(keys, k))
        if i < keys.shape[0] and keys[i] == k:
            return j * self.chunk + i
        return -1

    def nbytes(self) -> int:
        """Pinned bytes: compressed blobs + chunk directory."""
        return self.firsts.nbytes + sum(p.nbytes for p, _, _, _ in self.blobs)
