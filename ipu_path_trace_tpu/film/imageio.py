"""Image IO: dependency-free PNG and OpenEXR subsets.

The reference saves a tone-mapped PNG plus a `.exr` HDR alongside
(reference: src/AccumulatedImage.cpp:11-14,48-56, via OpenCV).  Both
writers here use the standard library only: PNG as 8-bit RGB with
unfiltered zlib-compressed scanlines, and the small subset of OpenEXR v2
needed here: single-part scanline images, NONE compression, HALF/FLOAT
channels.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_EXR_MAGIC = b"\x76\x2f\x31\x01"
_PT_HALF = 1
_PT_FLOAT = 2


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def write_png(path: str, ldr: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    ldr = np.ascontiguousarray(ldr, np.uint8)
    h, w, c = ldr.shape
    if c != 3:
        raise ValueError("write_png expects (H, W, 3) RGB")
    # Each scanline is prefixed with filter type 0 (None):
    raw = np.concatenate([np.zeros((h, 1), np.uint8), ldr.reshape(h, 3 * w)],
                         axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG written by write_png (8-bit RGB, unfiltered rows)
    -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, size = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack_from(">I", blob, pos)
        tag, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", blob, pos + 8 + n)
        if zlib.crc32(tag + data) != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        if tag == b"IHDR":
            size = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        pos += 12 + n
    if size is None or size[2:] != (8, 2, 0, 0, 0):
        raise ValueError("only 8-bit RGB, non-interlaced PNGs are supported")
    w, h = size[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("only unfiltered PNG scanlines are supported")
    return rows[:, 1:].reshape(h, w, 3).copy()


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def write_exr(path: str, hdr: np.ndarray, half: bool = False) -> None:
    """Write an (H, W, 3) float32 RGB image as scanline EXR (no compression)."""
    h, w, c = hdr.shape
    assert c == 3, "write_exr expects RGB"
    pixel_type = _PT_HALF if half else _PT_FLOAT
    np_type = np.float16 if half else np.float32
    bpp = 2 if half else 4

    # Channel list: alphabetical B, G, R (required ordering).
    chan = b""
    for name in (b"B", b"G", b"R"):
        chan += name + b"\0" + struct.pack("<i", pixel_type) + b"\x00\x00\x00\x00"
        chan += struct.pack("<ii", 1, 1)
    chan += b"\0"

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join(
        [
            _attr(b"channels", b"chlist", chan),
            _attr(b"compression", b"compression", b"\x00"),  # NONE
            _attr(b"dataWindow", b"box2i", box),
            _attr(b"displayWindow", b"box2i", box),
            _attr(b"lineOrder", b"lineOrder", b"\x00"),  # INCREASING_Y
            _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
            _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)),
            _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
            b"\0",
        ]
    )

    scan_bytes = 3 * w * bpp
    data_start = len(_EXR_MAGIC) + 4 + len(header) + 8 * h
    offsets = [data_start + y * (8 + scan_bytes) for y in range(h)]

    img = hdr.astype(np_type)
    with open(path, "wb") as f:
        f.write(_EXR_MAGIC)
        f.write(struct.pack("<I", 2))  # version 2, scanline
        f.write(header)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, scan_bytes))
            # Per-scanline channel planes in file channel order B, G, R:
            f.write(img[y, :, 2].tobytes())
            f.write(img[y, :, 1].tobytes())
            f.write(img[y, :, 0].tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read scanline EXR (NONE compression, HALF/FLOAT channels) -> (H, W, 3) f32."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != _EXR_MAGIC:
        raise ValueError("not an EXR file")
    pos = 8
    channels: list[tuple[str, int]] = []
    data_window = None
    compression = None
    while True:
        end = blob.index(b"\0", pos)
        if end == pos:  # header terminator
            pos += 1
            break
        name = blob[pos:end].decode()
        pos = end + 1
        end = blob.index(b"\0", pos)
        typ = blob[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", blob, pos)
        pos += 4
        payload = blob[pos : pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                ce = payload.index(b"\0", cp)
                cname = payload[cp:ce].decode()
                (ptype,) = struct.unpack_from("<i", payload, ce + 1)
                channels.append((cname, ptype))
                cp = ce + 1 + 16
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)
        elif name == "compression":
            compression = payload[0]
    if compression != 0:
        raise ValueError("only NONE compression supported")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    offsets = struct.unpack_from(f"<{h}Q", blob, pos)
    out = {}
    for off in offsets:
        (y, nbytes) = struct.unpack_from("<ii", blob, off)
        cur = off + 8
        for cname, ptype in channels:
            bpp = 2 if ptype == _PT_HALF else 4
            dt = np.float16 if ptype == _PT_HALF else np.float32
            row = np.frombuffer(blob, dt, count=w, offset=cur)
            out.setdefault(cname, np.zeros((h, w), np.float32))[y - y0] = row
            cur += w * bpp
    return np.stack([out["R"], out["G"], out["B"]], axis=-1)


def load_hdr_image(path: str) -> np.ndarray:
    """Read an HDR/LDR image as float32 radiance (H, W, 3).

    EXRs go through the built-in reader; everything else through
    imageio.  Integer-typed files carry the 0..255 encoding and are
    scaled to [0, 1]; float files (e.g. Radiance .hdr) are radiance
    already and must NOT be divided - one rule, shared by the --assets
    texture path and the NIF trainer.
    """
    if path.endswith(".exr"):
        return read_exr(path)
    import imageio.v3 as iio

    raw = iio.imread(path)
    img = np.asarray(raw, np.float32)
    if np.issubdtype(np.asarray(raw).dtype, np.integer):
        img = img / 255.0
    return img


def save_images(path: str, hdr_at_step: np.ndarray, ldr: np.ndarray) -> None:
    """Write <path> (PNG, tone-mapped) and <base>.exr (HDR / step).

    Mirrors AccumulatedImage::saveImages (AccumulatedImage.cpp:48-56).
    An ``.exr`` outfile gets the HDR at that exact path and the
    tone-mapped PNG alongside.
    """
    base, ext = os.path.splitext(path)
    if ext.lower() == ".exr":
        write_exr(path, hdr_at_step)
        write_png(base + ".png", ldr)
        return
    write_png(path, ldr)
    write_exr(base + ".exr", hdr_at_step)
