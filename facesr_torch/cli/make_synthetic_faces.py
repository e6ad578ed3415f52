"""Synthetic face-like images for dress rehearsals (the port of
`scripts/make_synthetic_faces.py`):

    python -m facesr_torch.cli.make_synthetic_faces --output /tmp/faces/raw \\
        --num 512 --size 160 --seed 0

An elliptical head on a gradient background, two eyes with irises and
highlights, brows, a nose shadow and a mouth, drawn at twice the size with
light texture noise, blurred and area-downsampled, so super-resolution
training has smooth regions, sharp edges and fine detail to learn from.
Image ``i`` draws from ``np.random.default_rng((seed, i))``, so a rerun
makes the same set. Host-side numpy, as in the JAX package: the drawing
is `data.draw` (OpenCV's 8-connected rasteriser, which is what cv2 draws
on a float canvas under ``LINE_AA``), the blur `cv_compat.gaussian_blur`
and the downsample `cv_compat.resize_area`, all bitwise cv2's on these
calls. The images are written as RGB PNGs (`data.png`); the JAX script
writes the same pixels through cv2 in BGR order, which decodes to the
same RGB.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from facesr_torch.data import draw
from facesr_torch.data.cv_compat import gaussian_blur, resize_area
from facesr_torch.data.png import write_png

__all__ = ["render_face", "write_faces", "main"]


def render_face(rng: np.random.Generator, size: int) -> np.ndarray:
    """One uint8 RGB face-like image of shape [size, size, 3]."""
    s = size
    # Oversample 2x and downsample at the end: cheap anti-aliasing so the
    # HR ground truth has clean sub-pixel edges worth super-resolving.
    S = s * 2
    img = np.zeros((S, S, 3), np.float32)

    # Background: diagonal two-color gradient.
    c0 = rng.uniform(30, 225, 3)
    c1 = rng.uniform(30, 225, 3)
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / (S - 1)
    t = (yy * rng.uniform(0.3, 1.0) + xx * rng.uniform(0.3, 1.0))
    t /= t.max()
    img += c0 * (1 - t[..., None]) + c1 * t[..., None]

    # Head: filled ellipse, slightly rotated, skin-ish but varied color.
    cx, cy = int(S * rng.uniform(0.42, 0.58)), int(S * rng.uniform(0.45, 0.58))
    ax, ay = int(S * rng.uniform(0.26, 0.34)), int(S * rng.uniform(0.32, 0.42))
    angle = rng.uniform(-12, 12)
    skin = np.array([rng.uniform(140, 235), rng.uniform(100, 190), rng.uniform(80, 170)])
    draw.ellipse(img, (cx, cy), (ax, ay), angle, 0, 360, skin.tolist(), -1)
    # Hair: darker cap ellipse clipped to the upper head.
    hair = (skin * rng.uniform(0.15, 0.5)).tolist()
    draw.ellipse(img, (cx, cy - int(ay * 0.55)), (int(ax * 1.05), int(ay * 0.62)),
                 angle, 180, 360, hair, -1)

    # Eyes: sclera + iris + pupil + highlight.
    eye_dx = int(ax * rng.uniform(0.38, 0.5))
    eye_y = cy - int(ay * rng.uniform(0.08, 0.2))
    eye_w = max(3, int(ax * rng.uniform(0.16, 0.22)))
    eye_h = max(2, int(eye_w * rng.uniform(0.45, 0.65)))
    iris = rng.uniform(20, 150, 3).tolist()
    for sx in (-1, 1):
        ex = cx + sx * eye_dx
        draw.ellipse(img, (ex, eye_y), (eye_w, eye_h), 0, 0, 360, (245, 245, 245), -1)
        r_iris = max(2, int(eye_h * 0.9))
        draw.circle(img, (ex, eye_y), r_iris, iris, -1)
        draw.circle(img, (ex, eye_y), max(1, r_iris // 2), (15, 15, 15), -1)
        draw.circle(img, (ex - r_iris // 3, eye_y - r_iris // 3), max(1, r_iris // 4),
                    (250, 250, 250), -1)
        # Brow.
        bw = int(eye_w * rng.uniform(1.1, 1.4))
        by = eye_y - int(eye_h * rng.uniform(1.8, 2.6))
        draw.ellipse(img, (ex, by), (bw, max(1, eye_h // 2)), sx * rng.uniform(0, 8),
                     200, 340, hair, max(1, S // 100))

    # Nose: subtle vertical shadow + tip.
    nose_y = cy + int(ay * rng.uniform(0.1, 0.22))
    shade = (skin * 0.8).tolist()
    draw.line(img, (cx, eye_y + eye_h), (cx, nose_y), shade, max(1, S // 120))
    draw.ellipse(img, (cx, nose_y), (max(2, int(ax * 0.09)), max(1, int(ax * 0.05))),
                 0, 0, 180, shade, -1)

    # Mouth: lip ellipse, sometimes open (teeth band).
    mouth_y = cy + int(ay * rng.uniform(0.42, 0.58))
    mw = int(ax * rng.uniform(0.32, 0.48))
    mh = max(2, int(mw * rng.uniform(0.25, 0.4)))
    lip = np.array([rng.uniform(120, 210), rng.uniform(30, 90), rng.uniform(40, 110)])
    draw.ellipse(img, (cx, mouth_y), (mw, mh), 0, 0, 360, lip.tolist(), -1)
    if rng.random() < 0.5:
        draw.ellipse(img, (cx, mouth_y - mh // 4), (int(mw * 0.7), max(1, mh // 3)),
                     0, 0, 360, (235, 235, 235), -1)

    # Fine texture: low-amplitude noise, then mild blur — gives the HR
    # images high-frequency content so x4 SR is non-trivial.
    img += rng.normal(0, 4.0, img.shape).astype(np.float32)
    img = gaussian_blur(img, 3, 0.8)
    img = resize_area(img, (s, s))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_faces(output: str, num: int, size: int = 160, seed: int = 0) -> List[str]:
    """Write ``face_{i:05d}.png`` for i < ``num`` into ``output``; returns
    the paths."""
    os.makedirs(output, exist_ok=True)
    paths = []
    for i in range(num):
        img = render_face(np.random.default_rng((seed, i)), size)
        path = os.path.join(output, f"face_{i:05d}.png")
        write_png(path, img)
        paths.append(path)
    return paths


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output", required=True, help="directory for PNG images")
    p.add_argument("--num", type=int, default=512)
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    write_faces(args.output, args.num, args.size, args.seed)
    print(f"wrote {args.num} images ({args.size}x{args.size}) to {args.output}")


if __name__ == "__main__":
    main()
