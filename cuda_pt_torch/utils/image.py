"""Image I/O (port of cuda_pt_tpu/utils/image.py; replaces the reference's
stb usage, src/impl/textures.cu:172-201).

PNG is decoded here with zlib, as the reference's PIL path reads it (the
card's machine has no PIL): 8- and 16-bit gray, gray+alpha, RGB and RGBA,
and palette images at 1, 2, 4 and 8 bits, filters 0-4, not interlaced. Like
PIL's, the array of a palette image holds its indices, a 16-bit colour
image (gray+alpha, RGB, RGBA) the high byte of each sample (gray+alpha
as RGBA), and 16-bit gray its 16 bits. Radiance ``.hdr`` (RGBE, flat and new-style RLE) decodes
as the reference decodes it. Other formats (JPG, BMP, TIFF) go through PIL
where it is installed. The normalization by the original bit depth and
the sRGB -> linear step are the reference's, in float32, so the results
are bit-equal to its.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """(…, 4) uint8 RGBE → (…, 3) float32 linear radiance (stb convention:
    rgb = mantissa * 2^(e-136); e==0 ⇒ black)."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0.0, np.exp2(e - 136.0), 0.0)
    return (rgbe[..., :3] * scale[..., None]).astype(np.float32)


def _load_hdr(path: str) -> np.ndarray:
    """Radiance RGBE `.hdr` → float32 (H, W, 3) linear radiance."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    # header: lines until a blank line, then the resolution line
    pos = 0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported HDR orientation {res!r}")
    H, W = int(res[1]), int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    out = np.empty((H, W, 4), np.uint8)
    i = 0
    for y in range(H):
        if (
            W >= 8
            and W < 32768
            and buf[i] == 2
            and buf[i + 1] == 2
            and (int(buf[i + 2]) << 8 | int(buf[i + 3])) == W
        ):
            # new-style RLE: 4 component planes, each run-length encoded
            i += 4
            for c in range(4):
                x = 0
                while x < W:
                    cnt = int(buf[i])
                    if cnt > 128:  # run of the same byte
                        out[y, x : x + cnt - 128, c] = buf[i + 1]
                        x += cnt - 128
                        i += 2
                    else:  # literal dump
                        out[y, x : x + cnt, c] = buf[i + 1 : i + 1 + cnt]
                        x += cnt
                        i += 1 + cnt
        else:
            # flat (or old-style) scanline: W raw RGBE pixels
            row = buf[i : i + 4 * W].reshape(W, 4)
            out[y] = row
            i += 4 * W
    return _decode_rgbe(out)


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the PNG scanline filters -> (h, stride) uint8. None, Sub and Up
    run on whole rows; Average and Paeth, whose bytes depend on the byte
    bpp to their left, byte by byte."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # sub: a running sum mod 256 along each byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # up
            cur = line + prev
        elif ftype in (3, 4):  # average, Paeth
            c, up = bytearray(line.tobytes()), prev.tobytes()
            for i in range(stride):
                a = c[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    c[i] = (c[i] + ((a + up[i]) >> 1)) & 0xFF
                    continue
                b = up[i]
                cc = up[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - 2 * cc)
                c[i] = (c[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else cc)) & 0xFF
            cur = np.frombuffer(bytes(c), np.uint8)
        else:
            raise ValueError(f"{path}: PNG filter type {ftype} is not one of 0-4")
        out[y] = cur
        prev = out[y]
    return out


def _load_png(path: str) -> np.ndarray:
    """A PNG's samples as PIL's np.asarray(Image.open(path)) gives them:
    (H, W) or (H, W, C), uint8, or uint16 for 16-bit gray."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = len(_PNG_SIG), None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or image data")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported; save it "
                         "non-interlaced")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not valid")
    if depth not in (8, 16) and not (ctype == 3 and depth in (1, 2, 4)):
        raise ValueError(f"{path}: PNG of colour type {ctype} at bit depth {depth} is not "
                         "supported (8 and 16 bits; palettes also at 1, 2 and 4)")
    ch = _PNG_CHANNELS[ctype]
    bits = ch * depth
    stride = (w * bits + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(bits // 8, 1), path)
    if depth < 8:  # palette indices packed high bits first
        px = np.unpackbits(rows, axis=1).reshape(h, stride * 8 // depth, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        img = (px * weights).sum(axis=-1).astype(np.uint8)[:, :w]
    elif depth == 16:
        img = rows.reshape(h, w, ch, 2)
        # PIL keeps 16-bit gray whole and the high byte of 16-bit colour,
        # and opens 16-bit gray+alpha as RGBA (L, L, L, A)
        img = (img.view(">u2")[..., 0].astype(np.uint16) if ctype == 0 else img[..., 0])
        if ctype == 4:
            img = img[..., [0, 0, 0, 1]]
    else:
        img = rows.reshape(h, w, ch)
    return img[..., 0] if img.ndim == 3 and ch == 1 else img


def _load_pil(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        ext = os.path.splitext(path)[1] or "(no extension)"
        raise RuntimeError(f"{path}: reading {ext} images needs PIL, which is not installed; "
                           "PNG and .hdr load without it") from None
    with Image.open(path) as img:
        return np.asarray(img)


def load_image(path: str, to_linear: bool = True) -> np.ndarray:
    """Load an image → float32 (H, W, C).

    LDR inputs (8/16-bit) are normalized to [0,1] by their ORIGINAL bit
    depth (checked before the float cast — a float TIFF with values > 2 is
    HDR data and must not be quantization-divided) and optionally converted
    sRGB→linear. ``.hdr`` files decode to linear radiance directly.
    """
    if path.lower().endswith(".hdr"):
        return np.ascontiguousarray(_load_hdr(path))
    with open(path, "rb") as f:
        is_png = f.read(len(_PNG_SIG)) == _PNG_SIG
    raw = _load_png(path) if is_png else _load_pil(path)
    orig_dtype = raw.dtype
    arr = raw.astype(np.float32)
    if orig_dtype == np.uint8:
        arr /= 255.0
    elif orig_dtype == np.uint16:
        arr /= 65535.0
    else:
        # float source (e.g. 32-bit TIFF): already radiometric, no transfer
        to_linear = False
    if arr.ndim == 2:
        arr = arr[..., None]
    if to_linear:
        arr = srgb_to_linear(arr)
    return np.ascontiguousarray(arr, dtype=np.float32)


def save_png(path: str, img: np.ndarray):
    """Write an (H, W, 3) RGB or (H, W, 4) RGBA image as an 8-bit PNG:
    uint8 as it is, floats in [0, 1] rounded as the reference rounds them."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    img = np.ascontiguousarray(img)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3) or (H, W, 4), got {img.shape}")
    h, w, c = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
