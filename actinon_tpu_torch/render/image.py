"""Image output + accumulation: packed 8-bit image, P6 PNM writer,
fold-hash regression oracle, and the weighted sample accumulator with
adaptive-gradient queries.

Counterparts: image_cps_s (reference src/scene.c:47-146), lum_image_s
(reference src/scene.c:744-886).  The accumulator is a numpy
struct-of-arrays rather than an array of lum_s records; semantics
(weighted sums per pixel, max-of-8-neighbours squared gradient) are
identical.  The hash is FNV-1a over the packed pixels -- beth's
bcore_tp_fold_u2 is not vendored in the reference, so the exact constants
are framework-defined; the hash's role (bit-level regression oracle,
printed per pass, reference src/scene.c:881) is preserved.
"""

from __future__ import annotations

import numpy as np


def pack_cps(img: np.ndarray) -> np.ndarray:
    """float RGB [H,W,3] -> packed u32 r|g<<8|b<<16 (cps_from_cl,
    reference src/scene.c:76-83): byte = clr*256 clamped to [0,255]."""
    try:
        from actinon_tpu_torch.native import pack_cps as native_pack
        return native_pack(img)
    except ImportError:
        pass
    b = np.clip((img * 256.0).astype(np.int64), 0, 255).astype(np.uint32)
    b[img <= 0.0] = 0
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)


_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def image_hash(packed: np.ndarray) -> int:
    """FNV-1a 64-bit fold over packed u32 pixels in row-major order.
    The xor-multiply chain is inherently sequential; the native C module
    does it at memory speed, with a python fallback."""
    flat = np.ascontiguousarray(packed.reshape(-1), dtype=np.uint64)
    try:
        from actinon_tpu_torch.native import fnv_fold
        return int(fnv_fold(flat))
    except ImportError:
        h = _FNV_OFFSET
        with np.errstate(over="ignore"):
            for v in flat:
                h = (h ^ v) * _FNV_PRIME
        return int(h)


def write_pnm(path: str, img: np.ndarray):
    """Binary P6 (image_cps_s_write_pnm, reference src/scene.c:122-137)."""
    h, w = img.shape[:2]
    packed = pack_cps(img)
    rgb = np.stack([(packed & 0xFF), (packed >> 8) & 0xFF,
                    (packed >> 16) & 0xFF], axis=-1).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.tobytes())


def read_pnm(path: str) -> np.ndarray:
    """Read binary P6 -> float RGB [H,W,3] in [0,1] (byte/256 inverse
    of pack)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        assert magic == b"P6", magic
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        maxv = int(f.readline())
        data = np.frombuffer(f.read(w * h * 3), np.uint8)
    return data.reshape(h, w, 3).astype(np.float64) / 256.0


class LumImage:
    """Weighted per-pixel accumulator with resume state
    (lum_image_s, reference src/scene.c:744-800)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.clr = np.zeros((height, width, 3), np.float64)
        self.weight = np.zeros((height, width), np.float64)
        self.gradient_cycle = 0
        self.rval = np.uint64(21943294)  # reference src/scene.c:800

    def push_samples(self, pos: np.ndarray, clr: np.ndarray,
                     weight: np.ndarray = None):
        """Bin samples at subpixel positions pos [N,2] (x, y) with colors
        clr [N,3] (lum_image_s_push, reference src/scene.c:804-813)."""
        if weight is None:
            weight = np.ones(len(pos))
        x = pos[:, 0].astype(np.int64)
        y = pos[:, 1].astype(np.int64)
        ok = (x >= 0) & (x < self.width) & (y >= 0) & (y < self.height)
        x, y = x[ok], y[ok]
        np.add.at(self.clr, (y, x), clr[ok] * weight[ok, None])
        np.add.at(self.weight, (y, x), weight[ok])

    def averaged(self) -> np.ndarray:
        """Per-pixel mean color (lum_image_s_get_avg, reference
        src/scene.c:824-835)."""
        w = np.where(self.weight > 0, self.weight, 1.0)
        return self.clr / w[..., None]

    def sqr_grad(self) -> np.ndarray:
        """Max squared color deviation over the 8-neighbourhood, per pixel
        (lum_image_s_sqr_grad, reference src/scene.c:848-862).
        Out-of-image neighbours contribute 0."""
        avg = self.averaged()
        H, W = self.height, self.width
        out = np.zeros((H, W), np.float64)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                ys = slice(max(0, dy), H + min(0, dy))
                xs = slice(max(0, dx), W + min(0, dx))
                ys0 = slice(max(0, -dy), H + min(0, -dy))
                xs0 = slice(max(0, -dx), W + min(0, -dx))
                dev = ((avg[ys0, xs0] - avg[ys, xs]) ** 2).sum(-1)
                out[ys0, xs0] = np.maximum(out[ys0, xs0], dev)
        return out

    # --- checkpoint (the reference serializes the whole record with
    # bcore_bin_ml, reference src/scene.c:1081,1151; we use npz) ---

    def save(self, path: str):
        np.savez(path, clr=self.clr, weight=self.weight,
                 gradient_cycle=self.gradient_cycle, rval=self.rval,
                 width=self.width, height=self.height)

    @staticmethod
    def load(path: str) -> "LumImage":
        z = np.load(path)
        o = LumImage(int(z["width"]), int(z["height"]))
        o.clr = z["clr"]
        o.weight = z["weight"]
        o.gradient_cycle = int(z["gradient_cycle"])
        o.rval = np.uint64(z["rval"])
        return o
