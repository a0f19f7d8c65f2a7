"""Frame output: npy, PNG and GIF (counterpart of ``volq/engine/io.py``).

numpy only.  The PNG writer is the portable stdlib one (zlib); the
reference's native encoder belongs to the JAX package and is not carried
over.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(rgba, gamma: float = 2.2):
    """fp32 linear RGBA -> uint8 sRGB-ish for display."""
    rgb = np.clip(np.asarray(rgba, np.float32)[..., :3], 0.0, 1.0)
    rgb = rgb ** (1.0 / gamma)
    a = np.clip(np.asarray(rgba)[..., 3:4], 0.0, 1.0)
    return (np.concatenate([rgb, a], -1) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, rgba_u8: np.ndarray):
    """RGBA8 PNG writer (stdlib zlib)."""
    h, w, c = rgba_u8.shape
    assert c == 4 and rgba_u8.dtype == np.uint8

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    raw = b"".join(b"\x00" + rgba_u8[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def save_npy(path: str, image):
    np.save(path, np.asarray(image))


def downscale_u8(img_u8: np.ndarray, max_width: int) -> np.ndarray:
    """Bilinear downscale (PIL) of a uint8 frame to at most ``max_width``
    columns -- keeps animated demo artifacts small."""
    if max_width <= 0 or img_u8.shape[1] <= max_width:
        return img_u8
    from PIL import Image
    im = Image.fromarray(img_u8)
    h = round(im.height * max_width / im.width)
    return np.asarray(im.resize((max_width, h), Image.BILINEAR))


def save_gif(path: str, frames, fps: float = 30.0):
    """Animated GIF from a list of uint8 [H, W, 3|4] frames."""
    from PIL import Image
    imgs = [Image.fromarray(np.asarray(f)[..., :3]) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(int(1000 / fps), 20), loop=0, optimize=True)
