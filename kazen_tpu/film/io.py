"""Image IO: PNG with sRGB tonemap (bitmap.cpp:38-64), a reader for those
PNGs, and self-contained EXR read/write (bitmap.cpp:7-36), replacing the
reference's OIIO dependency with zlib + struct."""
from __future__ import annotations

import struct

import numpy as np


def save_png(path: str, img: np.ndarray) -> None:
    """Per-pixel sRGB tonemap + 8-bit RGB PNG (bitmap.cpp:38-64), written
    with zlib + struct so no imaging library is needed."""
    import zlib

    from .film import to_srgb8

    srgb = to_srgb8(img)
    h, w = srgb.shape[:2]
    # every scanline starts with filter byte 0 (None)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), srgb.reshape(h, w * 3)], axis=1
    )

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return (
            struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
        )

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def load_png(path: str) -> np.ndarray:
    """Reads what ``save_png`` writes (8-bit RGB, every scanline with
    filter byte 0) into an (H, W, 3) uint8 array, with no imaging
    library."""
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, depth, ctype, _, _, interlace = header
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 3 * w + 1)
    if (depth, ctype, interlace) != (8, 2, 0) or raw[:, 0].any():
        raise ValueError(f"{path}: not an unfiltered 8-bit RGB PNG")
    return raw[:, 1:].reshape(h, w, 3).copy()


def save_exr(path: str, img: np.ndarray, compression: str = "none") -> None:
    """OpenEXR 2.0 writer: single part, scanline, float32, channels B,G,R
    (alphabetical, per spec). compression: "none" or "zip" (zlib over
    16-scanline chunks with the ImfZip predictor)."""
    import zlib

    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    comp_id = {"none": 0, "zip": 3}[compression]
    lines = 1 if comp_id == 0 else 16

    def attr(name, type_name, data):
        return (
            name.encode() + b"\0" + type_name.encode() + b"\0"
            + struct.pack("<i", len(data)) + data
        )

    def channel(name):
        # name, pixel type (2=float), pLinear+reserved, xSampling, ySampling
        return name.encode() + b"\0" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)

    chlist = channel("B") + channel("G") + channel("R") + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join(
        [
            attr("channels", "chlist", chlist),
            attr("compression", "compression", bytes([comp_id])),
            attr("dataWindow", "box2i", box),
            attr("displayWindow", "box2i", box),
            attr("lineOrder", "lineOrder", b"\0"),
            attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
            attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\0",
        ]
    )
    magic = struct.pack("<ii", 20000630, 2)
    chunks = []
    for y0 in range(0, h, lines):
        n_lines = min(lines, h - y0)
        payload = b"".join(
            img[y, :, c].tobytes()
            for y in range(y0, y0 + n_lines)
            for c in (2, 1, 0)  # B, G, R
        )
        if comp_id == 3:
            packed = zlib.compress(_exr_predict(payload))
            if len(packed) >= len(payload):  # spec: store raw if bigger
                packed = payload
        else:
            packed = payload
        chunks.append(struct.pack("<ii", y0, len(packed)) + packed)
    table_start = len(magic) + len(header)
    data_start = table_start + 8 * len(chunks)
    offsets = []
    off = data_start
    for ch in chunks:
        offsets.append(struct.pack("<Q", off))
        off += len(ch)
    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        f.write(b"".join(offsets))
        for ch in chunks:
            f.write(ch)


def _exr_predict(payload: bytes) -> bytes:
    """Inverse of _exr_unpredict: de-interleave then delta-encode."""
    d = np.frombuffer(payload, np.uint8)
    n = len(d)
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = d[0::2]
    t[half:] = d[1::2]
    p = t.astype(np.int16)
    p[1:] = p[1:] - t[:-1].astype(np.int16) + 128
    return (p & 0xFF).astype(np.uint8).tobytes()


def load_exr(path: str) -> np.ndarray:
    """EXR reader. The reference loads arbitrary EXRs through OIIO
    (bitmap.cpp:7-21); this native reader handles single-part scanline
    files with NONE / ZIPS / ZIP compression and HALF / FLOAT / UINT
    channels (the formats real env maps ship in). PIZ/tiled files fall
    back to cv2 when available."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    assert magic == 20000630, f"{path}: not an EXR file"
    try:
        return _load_exr_native(data)
    except _UnsupportedEXR as e:
        img = _load_exr_cv2(path)
        if img is not None:
            return img
        raise ValueError(f"{path}: {e} (and no cv2 fallback available)")


class _UnsupportedEXR(Exception):
    pass


_PIX_DTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_LINES_PER_CHUNK = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP


def _load_exr_native(data: bytes) -> np.ndarray:
    import zlib

    if struct.unpack_from("<i", data, 4)[0] & 0x200:
        raise _UnsupportedEXR("tiled EXR")
    pos = 8
    w = h = None
    channels = []  # (name, dtype)
    compression = 0
    while data[pos] != 0:
        name_end = data.index(b"\0", pos)
        name = data[pos:name_end].decode()
        pos = name_end + 1
        type_end = data.index(b"\0", pos)
        pos = type_end + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        if name == "dataWindow":
            x0, y0, x1, y1 = struct.unpack_from("<iiii", data, pos)
            w, h = x1 - x0 + 1, y1 - y0 + 1
        elif name == "compression":
            compression = data[pos]
        elif name == "channels":
            p = pos
            while data[p] != 0:
                ch_end = data.index(b"\0", p)
                cname = data[p:ch_end].decode()
                ptype, = struct.unpack_from("<i", data, ch_end + 1)
                xs, ys = struct.unpack_from("<ii", data, ch_end + 9)
                if ptype not in _PIX_DTYPE:
                    raise _UnsupportedEXR(f"channel type {ptype}")
                if (xs, ys) != (1, 1):
                    raise _UnsupportedEXR("subsampled channels")
                channels.append((cname, _PIX_DTYPE[ptype]))
                p = ch_end + 1 + 16
        pos += size
    pos += 1  # header terminator
    if compression not in _LINES_PER_CHUNK:
        raise _UnsupportedEXR(
            f"compression {compression} (only NONE/ZIPS/ZIP)"
        )
    lines = _LINES_PER_CHUNK[compression]
    n_chunks = -(-h // lines)
    pos += 8 * n_chunks  # offset table (chunks are sequential here)

    line_bytes = sum(w * np.dtype(dt).itemsize for _, dt in channels)
    planes = {name: np.zeros((h, w), dt) for name, dt in channels}
    for _ in range(n_chunks):
        y0, nbytes = struct.unpack_from("<ii", data, pos)
        pos += 8
        raw = data[pos: pos + nbytes]
        pos += nbytes
        n_lines = min(lines, h - y0)
        want = line_bytes * n_lines
        if compression == 0 or nbytes == want:
            buf = raw  # NONE, or a zip chunk stored raw (spec allows)
        else:
            buf = zlib.decompress(raw)
            if len(buf) != want:
                raise _UnsupportedEXR("bad zip chunk size")
            buf = _exr_unpredict(np.frombuffer(buf, np.uint8))
        off = 0
        for ly in range(n_lines):
            for cname, dt in channels:  # header order == file order
                nb = w * np.dtype(dt).itemsize
                planes[cname][y0 + ly] = np.frombuffer(
                    buf, dt, w, off
                )
                off += nb

    def chan(name):
        if name in planes:
            return planes[name].astype(np.float32)
        return np.zeros((h, w), np.float32)

    if "Y" in planes and "R" not in planes:
        y = chan("Y")
        return np.stack([y, y, y], -1)
    return np.stack([chan("R"), chan("G"), chan("B")], -1)


def _exr_unpredict(d: np.ndarray) -> bytes:
    """OpenEXR ImfZip reconstruction: delta-decode then de-interleave."""
    t = ((np.cumsum(d.astype(np.int64) - 128) + 128) & 0xFF).astype(np.uint8)
    n = len(t)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _load_exr_cv2(path: str):
    import os

    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            return None
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            return np.repeat(img[..., None], 3, axis=-1)
        return img[..., :3][..., ::-1].copy()  # BGR -> RGB
    except Exception:
        return None
