"""The port's on-read image renditions against the reference's
(tolerance 0).

* The reference's 11 cases (tests/test_images.py) on both packages.
* With PIL: `resized` and `cropped` give the same bytes in both
  packages for PNG, JPEG, GIF, BMP and WEBP, every mode, EXIF
  orientations 1-8, and a crop then a resize.
* The same through both clusters' GETs: healthy, from a gzip-stored
  image, and degraded, from a sealed volume that lost four shards.
* Without PIL (the card's machine has none) both packages serve the
  stored bytes, from the functions and from a GET.
"""
import gzip
import io
import sys
import time

import numpy as np
import pytest
import requests

from seaweedfs_tpu import images as ref_images
from seaweedfs_tpu.operation import verbs as ref_verbs
from seaweedfs_tpu.server import cluster as ref_cluster_mod
from seaweedfs_tpu.shell import repl as ref_repl
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu_torch import images as port_images
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell import repl
from seaweedfs_tpu_torch.shell.env import CommandEnv
from tests import test_images as ref_cases
from tests.torch_port_cases import port_cases, run_case, within

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

IMAGES = {"reference": ref_images, "port": port_images}
PORT_CASES = port_cases(ref_cases, images=port_images, verbs=verbs)
REF_CASES = port_cases(ref_cases)
FORMATS = {"png": "image/png", "jpeg": "image/jpeg", "gif": "image/gif",
           "bmp": "image/bmp", "webp": "image/webp"}
MODES = ("", "fit", "fill")
SIZES = ((40, 40), (50, 0), (0, 30), (200, 120))


def _encode(img, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt.upper(), **kw)
    return buf.getvalue()


def _picture(w: int, h: int, seed: int, mode: str = "RGB"):
    """Seeded noise over a gradient: every resize filter has work."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    px = np.stack([(xx * 255 // max(1, w - 1)),
                   (yy * 255 // max(1, h - 1)),
                   rng.integers(0, 256, (h, w))], axis=-1).astype(np.uint8)
    img = Image.fromarray(px, "RGB")
    return img.convert(mode) if mode != "RGB" else img


def _sample(fmt: str, seed: int = 0) -> bytes:
    img = _picture(97, 61, seed, "P" if fmt == "gif" else "RGB")
    return _encode(img, fmt)


def _oriented_jpeg(orientation: int) -> bytes:
    exif = Image.Exif()
    exif[0x0112] = orientation
    return _encode(_picture(64, 40, orientation), "jpeg", exif=exif)


def _size(data: bytes) -> tuple[int, int]:
    return Image.open(io.BytesIO(data)).size


# -- the reference's cases --------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One single-server cluster of each package, on the CPU codecs."""
    base = tmp_path_factory.mktemp("img")
    clusters = {}
    try:
        clusters["reference"] = within(
            60, ref_cluster_mod.Cluster, str(base / "ref"),
            n_volume_servers=1, volume_size_limit=16 << 20,
            ec_backend="numpy")
        clusters["port"] = within(
            60, Cluster, str(base / "port"), n_volume_servers=1,
            volume_size_limit=16 << 20,
            ec_backend=CudaCodec(device="cpu"))
        yield clusters
    finally:
        for c in clusters.values():
            within(60, c.stop)


def test_every_reference_case_is_mirrored():
    assert len(PORT_CASES) == len(REF_CASES) == 11


@pytest.mark.parametrize("side", ["reference", "port"])
@pytest.mark.parametrize("case", sorted(PORT_CASES))
def test_reference_image_cases(case, side, world):
    cases = PORT_CASES if side == "port" else REF_CASES
    run_case(cases[case], {"cluster": world[side]})


# -- the functions, byte for byte -------------------------------------------

@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("mode", MODES)
def test_resized_is_byte_equal(fmt, mode):
    data = _sample(fmt, seed=len(fmt))
    for w, h in SIZES:
        ref = ref_images.resized(data, FORMATS[fmt], w, h, mode)
        port = port_images.resized(data, FORMATS[fmt], w, h, mode)
        assert port == ref, (fmt, mode, w, h)
        assert ref != data
        if mode == "fill" and w and h:
            assert _size(port) == (w, h)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_is_byte_equal(orientation):
    data = _oriented_jpeg(orientation)
    for mode in MODES:
        ref = ref_images.resized(data, "image/jpeg", 32, 0, mode)
        assert port_images.resized(data, "image/jpeg", 32, 0, mode) == ref
    # orientations 5-8 swap the axes before any geometry math
    want_h = round(64 * 32 / 40) if orientation >= 5 else 20
    assert _size(ref) == (32, want_h)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_cropped_then_resized_is_byte_equal(fmt):
    data, mime = _sample(fmt, seed=3), FORMATS[fmt]
    for box in ((5, 5, 60, 40), (-4, -2, 30, 30), (0, 0, 97, 61),
                (0, 0, 98, 61), (30, 30, 10, 40)):
        ref = ref_images.cropped(data, mime, *box)
        port = port_images.cropped(data, mime, *box)
        assert port == ref, (fmt, box)
        if fmt in ("bmp", "webp") or box in ((0, 0, 98, 61),
                                            (30, 30, 10, 40)):
            assert port is data  # not croppable, out of bounds or empty
        assert port_images.resized(port, mime, 20, 20, "fit") == \
            ref_images.resized(ref, mime, 20, 20, "fit")


@pytest.mark.parametrize("side", ["reference", "port"])
def test_without_pil_the_stored_bytes_are_served(side, monkeypatch):
    data = _sample("png")
    monkeypatch.setitem(sys.modules, "PIL", None)
    mod = IMAGES[side]
    assert mod.resized(data, "image/png", 10, 10, "fit") is data
    assert mod.cropped(data, "image/png", 0, 0, 10, 10) is data


# -- through the clusters ----------------------------------------------------

QUERIES = (
    {"width": 40, "height": 40, "mode": "fit"},
    {"width": 40, "height": 40, "mode": "fill"},
    {"width": 30},
    {"height": 25, "mode": ""},
    {"crop_x1": 5, "crop_y1": 4, "crop_x2": 60, "crop_y2": 50},
    {"crop_x1": 5, "crop_y1": 4, "crop_x2": 60, "crop_y2": 50,
     "width": 20, "height": 20, "mode": "fit"},
    {"crop_x2": 500, "crop_y2": 500},
    {"width": "x"},
)
VERBS = {"reference": ref_verbs, "port": verbs}


def _gallery() -> dict[str, tuple[bytes, str, bool]]:
    """name -> (bytes, mime, stored gzipped)."""
    out = {f"a.{fmt}": (_sample(fmt, seed=i), mime, False)
           for i, (fmt, mime) in enumerate(sorted(FORMATS.items()))}
    out["exif6.jpeg"] = (_oriented_jpeg(6), "image/jpeg", False)
    out["gz.png"] = (_sample("png", seed=9), "image/png", True)
    out["gz.bmp"] = (_sample("bmp", seed=10), "image/bmp", True)
    return out


@pytest.fixture(scope="module")
def stored(world):
    """Every picture of the gallery written to both clusters in the
    "img" collection. -> {side: {name: fid url}}."""
    out = {}
    for side, c in world.items():
        out[side] = {}
        for name, (data, mime, gz) in _gallery().items():
            a = VERBS[side].assign(c.master_url, collection="img")
            url = f"http://{a.url}/{a.fid}"
            headers = {"Content-Type": mime}
            body = data
            if gz:
                body = gzip.compress(data, mtime=0)
                headers["Content-Encoding"] = "gzip"
            r = requests.post(url, data=body, headers=headers, timeout=30)
            assert r.status_code == 201, r.text
            out[side][name] = url
    return out


def _answers(urls: dict) -> dict:
    out = {}
    for name, url in sorted(urls.items()):
        for i, q in enumerate(QUERIES):
            r = requests.get(url, params=q, timeout=30)
            assert r.status_code == 200, (name, q, r.status_code)
            out[(name, i)] = r.content
    return out


def _expected(name: str, q: dict) -> bytes:
    data, mime, _gz = _gallery()[name]
    if "crop_x2" in q:
        data = port_images.cropped(data, mime, q.get("crop_x1", 0),
                                   q.get("crop_y1", 0), q["crop_x2"],
                                   q["crop_y2"])
    w, h = q.get("width", 0), q.get("height", 0)
    if isinstance(w, int) and (w or h):
        data = port_images.resized(data, mime, w, h, q.get("mode", ""))
    return data


def test_get_renditions_are_byte_equal(stored):
    ref, port = _answers(stored["reference"]), _answers(stored["port"])
    assert port == ref
    for (name, i), body in port.items():
        assert body == _expected(name, QUERIES[i]), (name, QUERIES[i])


@pytest.mark.parametrize("side", ["reference", "port"])
def test_get_without_pil_serves_the_stored_bytes(side, stored,
                                                 monkeypatch):
    gallery = _gallery()
    monkeypatch.setitem(sys.modules, "PIL", None)
    for name, url in stored[side].items():
        data = gallery[name][0]
        for q in QUERIES:
            r = requests.get(url, params=q, timeout=30)
            assert (r.status_code, r.content) == (200, data), (name, q)


def test_degraded_get_renditions_are_byte_equal(world, stored):
    """Seal every volume of the gallery in both clusters, drop four of
    each one's shards (data shards 0-3), and read every rendition again
    through the degraded path."""
    healthy = _answers(stored["port"])
    for side, (env_cls, run) in {
            "reference": (RefEnv, ref_repl.run_command),
            "port": (CommandEnv, repl.run_command)}.items():
        env = env_cls(world[side].master_url)
        assert run(env, "lock") == "locked"
        vids = sorted({int(u.rsplit("/", 1)[1].split(",")[0])
                       for u in stored[side].values()})
        for vid in vids:
            run(env, f"ec.encode -volumeId={vid}")
        for vid in vids:
            locs = env.ec_shard_locations(vid)
            for sid in range(4):
                for url in locs.get(sid, []):
                    env.vs_post(url, "/admin/ec/delete",
                                {"volume": vid, "shard_ids": [sid]})
            deadline = time.monotonic() + 20
            while set(range(4)) & set(env.ec_shard_locations(vid)):
                assert time.monotonic() < deadline, "loss not registered"
                time.sleep(0.05)
        assert run(env, "unlock") == "unlocked"
    ref, port = _answers(stored["reference"]), _answers(stored["port"])
    assert port == ref == healthy
