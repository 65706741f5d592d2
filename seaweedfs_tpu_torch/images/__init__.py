"""On-read image transforms; the counterpart of
seaweedfs_tpu/images/__init__.py.

Equivalent of SeaweedFS weed/images/resizing.go (+ the
orientation fix, orientation.go), hooked into the volume read path
where the reference does it (volume_server_handlers_read.go:294-353): a
GET for an image fid may carry ?width=&height=&mode= and receives a
resized rendition; the stored bytes are untouched.

Modes (resizing.go Resized):
    ""     exact resize to width x height (single dimension keeps the
           aspect ratio)
    fit    largest resize that fits inside the box, ratio preserved
    fill   cover the box then center-crop to exactly width x height

PIL is imported inside `resized` and `cropped`, as the reference does,
and where it is missing both serve the original bytes: it decodes and
encodes images, no device work, and a host without it answers exactly
as the reference's does there.
"""
from __future__ import annotations

import io

_FORMATS = {"image/jpeg": "JPEG", "image/png": "PNG",
            "image/gif": "GIF", "image/webp": "WEBP",
            "image/bmp": "BMP"}


def is_image_mime(mime: str) -> bool:
    return mime.split(";")[0].strip().lower() in _FORMATS


def cropped(data: bytes, mime: str, x1: int, y1: int,
            x2: int, y2: int) -> bytes:
    """Crop to the (x1,y1)-(x2,y2) rectangle — the ?crop_x1=… GET
    params (volume_server_handlers_read.go:336 shouldCropImages +
    images/cropping.go Cropped; applied BEFORE any resize, like the
    reference). The reference crops png/jpeg/gif only and serves the
    original when the rectangle falls outside the image or the bytes
    don't decode; same here."""
    kind = mime.split(";")[0].strip().lower()
    if kind not in ("image/png", "image/jpeg", "image/gif"):
        return data
    try:
        from PIL import Image
    except ImportError:
        return data
    try:
        img = Image.open(io.BytesIO(data))
        img.load()
    except Exception:
        return data
    w, h = img.size
    if x2 > w or y2 > h:  # cropping.go:24 out-of-bounds -> original
        return data
    # clamp the origin into bounds: PIL pads negative coordinates
    # with black, the reference's crop intersects with the image
    x1, y1 = max(0, x1), max(0, y1)
    if x1 >= x2 or y1 >= y2:  # clamping emptied the box
        return data
    out = img.crop((x1, y1, x2, y2))
    fmt = _FORMATS[kind]
    if fmt == "JPEG" and out.mode not in ("RGB", "L"):
        out = out.convert("RGB")
    buf = io.BytesIO()
    out.save(buf, format=fmt)
    return buf.getvalue()


def resized(data: bytes, mime: str, width: int = 0, height: int = 0,
            mode: str = "") -> bytes:
    """Return a resized rendition of `data`, or the original bytes when
    no resize applies (no dims, undecodable, or already smaller the way
    the reference short-circuits NewImage errors)."""
    if width <= 0 and height <= 0:
        return data
    fmt = _FORMATS.get(mime.split(";")[0].strip().lower())
    if fmt is None:
        return data
    try:
        from PIL import Image, ImageOps
    except ImportError:  # stripped-down runtime: serve original bytes
        return data
    try:
        img = Image.open(io.BytesIO(data))
        img.load()
    except Exception:
        return data  # resizing.go: undecodable -> original bytes
    # camera EXIF orientation is honored before any geometry math
    # (images/orientation.go FixJpgOrientation)
    img = ImageOps.exif_transpose(img)
    w, h = img.size
    if width <= 0:
        width = max(1, round(w * height / h))
    if height <= 0:
        height = max(1, round(h * width / w))
    if mode == "fit":
        out = ImageOps.contain(img, (width, height))
    elif mode == "fill":
        out = ImageOps.fit(img, (width, height))
    else:
        out = img.resize((width, height))
    buf = io.BytesIO()
    save_kw = {}
    if fmt == "JPEG" and out.mode not in ("RGB", "L"):
        out = out.convert("RGB")
    if fmt == "GIF":
        save_kw["save_all"] = False
    out.save(buf, format=fmt, **save_kw)
    return buf.getvalue()
