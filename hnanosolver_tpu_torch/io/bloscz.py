"""Pure-Python Blosc1 + LZ4-block codec for OpenVDB ``.vdb`` ingestion.

Houdini (and any OpenVDB build with blosc) writes leaf buffers through
``io::Compression.cc``'s blosc path: an ``Int64`` byte count followed by a
c-blosc-1 container whose internal codec OpenVDB pins to LZ4
(``BLOSC_LZ4_COMPNAME``) with byte-shuffle at ``typesize=sizeof(float)``.
The reference consumes such files through Houdini's OpenVDB
(`reference/src/Utils/Utils.hpp:366-410`); this framework has no
blosc/lz4 library in its image, so the container and codec are implemented
here from the public formats:

- LZ4 block format (token/literals/offset/matchlen sequences).
- c-blosc 1.x container: 16-byte header, per-block ``int32`` start offsets,
  blocks optionally split into ``typesize`` streams (header flag bit 4
  records the choice from c-blosc 1.9 on), each stream an ``int32`` byte
  count + LZ4 data (count == stream size means stored raw), then byte
  unshuffle.

The encoder exists to build round-trip tests and foreign-layout fixtures;
it favors simplicity (greedy LZ4 matches) over ratio.

No real blosc implementation exists in this image to validate against, so
the container logic follows c-blosc 1.21 semantics closely and the reader
falls back between split/non-split interpretations for pre-1.9 headers.
"""

from __future__ import annotations

import struct

import numpy as np

# c-blosc header flag bits
_F_BYTESHUFFLE = 0x1
_F_MEMCPYED = 0x2
_F_BITSHUFFLE = 0x4
_F_DONT_SPLIT = 0x10
# compressor codes (flags bits 5-7)
_C_BLOSCLZ, _C_LZ4 = 0, 1
_MAX_SPLITS = 16
_BLOSC_VERSION_FORMAT = 2
_MAX_OVERHEAD = 16  # BLOSC_MAX_OVERHEAD (header bytes)


# ---------------------------------------------------------------------------
# LZ4 block codec
# ---------------------------------------------------------------------------


def lz4_decompress(src: bytes, dst_size: int) -> bytes:
    """Decode one LZ4 *block* (not frame) of known decompressed size."""
    dst = bytearray(dst_size)
    s, d, n = 0, 0, len(src)
    while s < n:
        token = src[s]
        s += 1
        # literals
        ll = token >> 4
        if ll == 15:
            while True:
                b = src[s]
                s += 1
                ll += b
                if b != 255:
                    break
        if ll:
            dst[d:d + ll] = src[s:s + ll]
            s += ll
            d += ll
        if s >= n:
            break  # last sequence carries literals only
        # match
        off = src[s] | (src[s + 1] << 8)
        s += 2
        if off == 0:
            raise ValueError("lz4: zero match offset")
        ml = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[s]
                s += 1
                ml += b
                if b != 255:
                    break
        if off >= ml:  # non-overlapping: slice copy
            dst[d:d + ml] = dst[d - off:d - off + ml]
            d += ml
        else:  # overlapping match: byte-by-byte semantics
            for _ in range(ml):
                dst[d] = dst[d - off]
                d += 1
    if d != dst_size:
        raise ValueError(f"lz4: decoded {d} bytes, want {dst_size}")
    return bytes(dst)


def lz4_compress(src: bytes) -> bytes:
    """Greedy LZ4 block encoder (hash-chain-free; fixture quality).

    Honors the format's closing rules: the last 5 bytes are always
    literals and the last match starts no closer than 12 bytes from the
    block end."""
    n = len(src)
    out = bytearray()
    table: dict = {}
    anchor = 0
    i = 0
    limit = n - 12  # last match must start before here (format rule)

    def emit(lit_start, lit_end, off=None, mlen=0):
        ll = lit_end - lit_start
        token_l = 15 if ll >= 15 else ll
        token_m = 0 if off is None else (15 if mlen - 4 >= 15 else mlen - 4)
        out.append((token_l << 4) | token_m)
        rest = ll - 15
        while rest >= 0:
            out.append(min(rest, 255))
            if rest < 255:
                break
            rest -= 255
        out.extend(src[lit_start:lit_end])
        if off is not None:
            out.append(off & 0xFF)
            out.append(off >> 8)
            rest = mlen - 4 - 15
            while rest >= 0:
                out.append(min(rest, 255))
                if rest < 255:
                    break
                rest -= 255

    while i < limit:
        key = src[i:i + 4]
        j = table.get(key)
        table[key] = i
        if j is not None and i - j <= 0xFFFF and src[j:j + 4] == key:
            mlen = 4
            maxm = n - 5 - i  # keep 5 literal bytes at block end
            while mlen < maxm and src[j + mlen] == src[i + mlen]:
                mlen += 1
            if mlen >= 4:
                emit(anchor, i, i - j, mlen)
                i += mlen
                anchor = i
                continue
        i += 1
    emit(anchor, n)
    return bytes(out)


# ---------------------------------------------------------------------------
# Byte shuffle
# ---------------------------------------------------------------------------


def _unshuffle(b: bytes, typesize: int) -> bytes:
    a = np.frombuffer(b, np.uint8)
    nel = len(b) // typesize
    return a.reshape(typesize, nel).T.tobytes()


def _shuffle(b: bytes, typesize: int) -> bytes:
    a = np.frombuffer(b, np.uint8)
    nel = len(b) // typesize
    return a.reshape(nel, typesize).T.tobytes()


# ---------------------------------------------------------------------------
# Blosc1 container
# ---------------------------------------------------------------------------


def _decode_codec(comp_code: int, data: bytes, out_size: int) -> bytes:
    if comp_code == _C_LZ4:
        return lz4_decompress(data, out_size)
    raise ValueError(f"blosc: unsupported internal codec {comp_code} "
                     "(OpenVDB pins LZ4)")


def _decompress_block(src: bytes, pos: int, neblock: int, nsplits: int,
                      comp_code: int) -> bytes:
    parts = []
    nstream = neblock // nsplits
    for _ in range(nsplits):
        (cb,) = struct.unpack_from("<i", src, pos)
        pos += 4
        if cb == nstream:  # stored raw
            parts.append(src[pos:pos + nstream])
        elif cb < 0:
            raise ValueError("blosc: negative stream size")
        else:
            parts.append(_decode_codec(comp_code, src[pos:pos + cb], nstream))
        pos += abs(cb)
    return b"".join(parts)


def blosc_decompress(src: bytes) -> bytes:
    """Decode one c-blosc-1 buffer (as produced by ``blosc_compress``)."""
    if len(src) < _MAX_OVERHEAD:
        raise ValueError("blosc: truncated header")
    version, versionlz, flags, typesize = src[0], src[1], src[2], src[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<iii", src, 4)
    if version > _BLOSC_VERSION_FORMAT + 1:
        raise ValueError(f"blosc: format version {version} unsupported")
    if flags & _F_BITSHUFFLE:
        raise ValueError("blosc: bit-shuffle unsupported")
    if nbytes == 0:
        return b""
    if flags & _F_MEMCPYED:
        return src[_MAX_OVERHEAD:_MAX_OVERHEAD + nbytes]
    comp_code = flags >> 5
    shuffled = bool(flags & _F_BYTESHUFFLE) and typesize > 1
    nblocks = (nbytes + blocksize - 1) // blocksize
    bstarts = struct.unpack_from(f"<{nblocks}i", src, _MAX_OVERHEAD)

    def split_of(neblock, leftover, dont_split_bit):
        if dont_split_bit or not shuffled:
            return 1
        if typesize <= _MAX_SPLITS and neblock % typesize == 0 and not leftover:
            return typesize
        return 1

    def run(dont_split_bit):
        out = []
        for j in range(nblocks):
            neblock = min(blocksize, nbytes - j * blocksize)
            leftover = neblock != blocksize
            ns = split_of(neblock, leftover, dont_split_bit)
            blk = _decompress_block(src, bstarts[j], neblock, ns, comp_code)
            if shuffled and neblock % typesize == 0:
                blk = _unshuffle(blk, typesize)
            out.append(blk)
        return b"".join(out)

    if version >= 2 or True:
        # c-blosc >= 1.9 records the split choice in flag bit 4; older
        # encoders don't, so fall back to the other interpretation if the
        # recorded/derived one fails to decode.
        try:
            return run(bool(flags & _F_DONT_SPLIT))
        except (ValueError, IndexError, struct.error):
            return run(not bool(flags & _F_DONT_SPLIT))


def blosc_compress(data: bytes, typesize: int = 4,
                   blocksize: int = 0, shuffle: bool = True) -> bytes:
    """Encode a c-blosc-1 buffer (LZ4 internal codec, split streams —
    the layout c-blosc emits for OpenVDB's float leaf buffers)."""
    nbytes = len(data)
    if blocksize <= 0:
        blocksize = min(max(nbytes, typesize), 32 * 1024)
    if typesize <= 1:
        shuffle = False
    flags = (_C_LZ4 << 5) | (_F_BYTESHUFFLE if shuffle else 0)
    nblocks = max(1, (nbytes + blocksize - 1) // blocksize)
    blocks = []
    for j in range(nblocks):
        raw = data[j * blocksize:(j + 1) * blocksize]
        neblock = len(raw)
        leftover = neblock != blocksize
        if shuffle and neblock % typesize == 0:
            raw = _shuffle(raw, typesize)
        ns = (typesize if shuffle and typesize <= _MAX_SPLITS
              and neblock % typesize == 0 and not leftover else 1)
        nstream = neblock // ns
        enc = bytearray()
        for s in range(ns):
            stream = raw[s * nstream:(s + 1) * nstream]
            c = lz4_compress(stream)
            if len(c) >= nstream:  # doesn't shrink: store raw
                enc += struct.pack("<i", nstream) + stream
            else:
                enc += struct.pack("<i", len(c)) + c
        blocks.append(bytes(enc))
    header_len = _MAX_OVERHEAD + 4 * nblocks
    total = header_len + sum(len(b) for b in blocks)
    if total >= nbytes + _MAX_OVERHEAD:  # compression lost: memcpy mode
        head = struct.pack(
            "<BBBBiii", _BLOSC_VERSION_FORMAT, 1,
            _F_MEMCPYED | (_C_LZ4 << 5), typesize, nbytes, blocksize,
            nbytes + _MAX_OVERHEAD)
        return head + data
    head = struct.pack("<BBBBiii", _BLOSC_VERSION_FORMAT, 1, flags, typesize,
                       nbytes, blocksize, total)
    bstarts = []
    pos = header_len
    for b in blocks:
        bstarts.append(pos)
        pos += len(b)
    return head + struct.pack(f"<{nblocks}i", *bstarts) + b"".join(blocks)
