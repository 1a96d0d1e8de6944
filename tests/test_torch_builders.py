"""The port's dataset builders, folder dataset, transforms and image bytes
against the JAX package's, on the CPU.

The same tiny trees, written here (RGB, grayscale and CMYK JPEGs, a PNG
under a ``.JPEG`` name, a file that is no image), go through each JAX
builder and its port twin: shard names, record counts and the shards'
bytes must be equal (both sides re-encode with PIL at quality 95 on the
CPU, so every decoded feature is equal too). The raw crops decode with
PIL and resize with torch where JAX uses tf: on the committed JPEG
fixtures their frames stay within ``tests/test_torch_imagenet.py``'s
decode bounds (4 uint8 steps at most, 1.5 on average); on the noisy
files here, against JAX with tf's accurate IDCT, within 1 step; labels
and sizes equal. The port names the file it
cannot convert; the JAX builder drops it. The spawn pool runs once, with
2 workers. The folder dataset and the transforms go op for op against
JAX's with the same ``numpy.random.Generator``, with cv2 and with cv2
set to None on both sides. The header, PNG and metadata readers are held
to PIL and the JAX package.
"""

import functools
import io
import json
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from deepvision_tpu.data import folder as jax_folder
from deepvision_tpu.data import metadata as jax_metadata
from deepvision_tpu.data import transforms as jax_T
from deepvision_tpu.data.builders import detection as jax_detection
from deepvision_tpu.data.builders import gan as jax_gan
from deepvision_tpu.data.builders import imagenet as jax_imagenet
from deepvision_tpu.data.builders import imagenet_bbox as jax_bbox
from deepvision_tpu.data.builders import pose as jax_pose
from deepvision_tpu.data.builders import raw_crops as jax_raw
from deepvision_tpu.data.image_io import ensure_rgb_jpeg as jax_ensure
from deepvision_tpu_torch.data import folder, image_io, metadata
from deepvision_tpu_torch.data import transforms as T
from deepvision_tpu_torch.data.builders import (
    detection,
    gan,
    imagenet,
    imagenet_bbox,
    pose,
    raw_crops,
)
from deepvision_tpu_torch.data.builders.__main__ import main as builders_main
from deepvision_tpu_torch.data.tfrecord import decode_example, read_records
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)


@pytest.fixture(autouse=True)
def _delete_what_the_test_wrote(tmp_path):
    """The shards, checkpoints and images a test writes go with it (the
    suite's workers share one temp disk)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)

WNIDS = ["n01440764", "n01443537", "n01484850"]


def _smooth(rng, h, w):
    """A smooth seeded uint8 RGB image (a 4x4 field upsampled, mild
    noise), so that JPEG round trips stay near the pixels."""
    low = Image.fromarray(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8))
    up = np.asarray(low.resize((w, h), Image.BILINEAR), np.float32)
    return np.clip(np.round(up + rng.normal(0, 2, (h, w, 3))), 0,
                   255).astype(np.uint8)


def _save(img: Image.Image, path: Path, fmt: str, **kw) -> None:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    path.write_bytes(buf.getvalue())


def _image_tree(d: Path, rng) -> list[str]:
    """Eight flattened-ImageNet files: RGB JPEGs (one progressive), a
    grayscale and a CMYK JPEG, a PNG and an RGBA PNG under ``.JPEG``
    names, and one file that is no image. Returns the files' names."""
    d.mkdir(parents=True)
    kinds = ["rgb", "rgb", "gray", "cmyk", "png", "progressive", "rgba",
             "garbage"]
    names = []
    for i, kind in enumerate(kinds):
        name = f"{WNIDS[i % 3]}_{i}.JPEG"
        names.append(name)
        img = Image.fromarray(_smooth(rng, 40 + 3 * i, 56 - 2 * i))
        path = d / name
        if kind == "garbage":
            path.write_bytes(b"not an image")
        elif kind in ("png", "rgba"):
            _save(img.convert("RGBA") if kind == "rgba" else img, path,
                  "PNG")
        elif kind == "gray":
            _save(img.convert("L"), path, "JPEG", quality=90)
        elif kind == "cmyk":
            _save(img.convert("CMYK"), path, "JPEG", quality=90)
        else:
            _save(img, path, "JPEG", quality=90,
                  progressive=kind == "progressive")
    return names


def _shards(d: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if not p.name.endswith(".json")}


def _assert_same_shards(port_dir: Path, jax_dir: Path) -> None:
    port, jax = _shards(port_dir), _shards(jax_dir)
    assert list(port) == list(jax)
    for name in port:
        assert port[name] == jax[name], name


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("builders")
    rng = np.random.default_rng(0)
    names = _image_tree(root / "images", rng)
    (root / "synsets.txt").write_text("\n".join(WNIDS) + "\n")
    (root / "human.txt").write_text(
        "".join(f"{w}\tname of {w}\n" for w in WNIDS))
    # a bounding-box XML tree for two of the files (one box degenerate)
    for i, name in enumerate(names[:2]):
        syn = name.split("_")[0]
        (root / "bbox" / syn).mkdir(parents=True, exist_ok=True)
        objects = "".join(
            f"<object><bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin>"
            f"<xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>"
            for x0, y0, x1, y1 in ((3, 4, 30 + i, 33), (9, 9, 9, 20)))
        (root / "bbox" / syn / f"{Path(name).stem}.xml").write_text(
            f"<annotation><filename>{Path(name).stem}</filename><size>"
            f"<width>56</width><height>40</height></size>{objects}"
            "</annotation>")
    yield root, names
    shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------- metadata


def test_metadata_equals_jax():
    assert metadata.imagenet_synsets() == jax_metadata.imagenet_synsets()
    assert (metadata.imagenet_val_synsets()
            == jax_metadata.imagenet_val_synsets())
    assert len(metadata.imagenet_val_synsets()) == 50_000
    assert (metadata.imagenet_wnid_to_index()
            == jax_metadata.imagenet_wnid_to_index())
    assert metadata.imagenet_label_name(0) == \
        jax_metadata.imagenet_label_name(0)
    for ds in ("voc", "mscoco"):
        assert metadata.class_names(ds) == jax_metadata.class_names(ds)


# ---------------------------------------------------------- image bytes


@pytest.mark.parametrize("mode,kw", [("RGB", {}), ("L", {}), ("CMYK", {}),
                                     ("RGB", {"progressive": True}),
                                     ("RGB", {"subsampling": 0})])
def test_jpeg_header_gives_pil_size_and_mode(mode, kw):
    img = Image.fromarray(_smooth(np.random.default_rng(1), 37, 53))
    buf = io.BytesIO()
    img.convert(mode).save(buf, "JPEG", **kw)
    header = image_io.jpeg_header(buf.getvalue())
    opened = Image.open(io.BytesIO(buf.getvalue()))
    assert (header["width"], header["height"]) == opened.size
    assert {1: "L", 3: "RGB", 4: "CMYK"}[header["components"]] == \
        opened.mode
    assert header["progressive"] == bool(kw.get("progressive"))
    assert image_io.jpeg_header(b"\x89PNG\r\n\x1a\n") is None


def _png_with_filters(pixels: np.ndarray, filters) -> bytes:
    """An 8-bit RGB PNG whose row y uses ``filters[y % len(filters)]``
    (the encoder side of the five row filters, written out here)."""
    h, w, c = pixels.shape
    rows, prev = [], np.zeros(w * c, np.int32)
    for y in range(h):
        cur = pixels[y].reshape(-1).astype(np.int32)
        kind = filters[y % len(filters)]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_read_png_undoes_each_row_filter(filters):
    pixels = _smooth(np.random.default_rng(2), 23, 31)
    data = _png_with_filters(pixels, filters)
    np.testing.assert_array_equal(image_io.read_png(data), pixels)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), pixels)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1",
                                  "P4"])
def test_read_png_equals_pil_convert_rgb(mode):
    img = Image.fromarray(_smooth(np.random.default_rng(3), 29, 41))
    kw = {}
    if mode == "P4":
        img, kw = img.convert("P", palette=Image.ADAPTIVE, colors=16), \
            {"bits": 4}
    elif mode == "P":
        img = img.convert("P", palette=Image.ADAPTIVE, colors=50)
    else:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(image_io.read_png(buf.getvalue()), want)


def test_read_png_refuses_what_it_does_not_read():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, "PNG")
    with pytest.raises(ValueError, match="16-bit gray"):
        image_io.read_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.read_png(b"GIF89a")
    bad = bytearray(image_io.encode_png(np.zeros((2, 2, 3), np.uint8)))
    bad[30] ^= 0xFF  # inside IHDR: its CRC fails
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_png(bytes(bad))


def test_ensure_rgb_jpeg_equals_jax_byte_for_byte(tree):
    """Every kind of file: the same bytes and size as the JAX repair on
    the CPU, and the same refusal of a file that is no image."""
    root, names = tree
    for name in names:
        data = (root / "images" / name).read_bytes()
        if name.endswith("_7.JPEG"):  # the garbage file
            with pytest.raises(Exception):
                jax_ensure(data)
            with pytest.raises(Exception):
                image_io.ensure_rgb_jpeg(data, "cpu")
            continue
        got = image_io.ensure_rgb_jpeg(data, "cpu")
        assert got == jax_ensure(data), name
        assert image_io.jpeg_header(got[0])["components"] == 3


# ------------------------------------------------------------- builders


def test_imagenet_builder_and_bbox_csv_equal_jax(tree, tmp_path, capsys):
    """The bbox CSV text, then the shards (bboxes, human labels, the
    repaired files) equal JAX's; the garbage file is named in the port's
    summary; the port's reader reads each record's label and size."""
    root, names = tree
    csv_port, csv_jax = tmp_path / "port.csv", tmp_path / "jax.csv"
    assert imagenet_bbox.process_bounding_boxes(root / "bbox", csv_port) \
        == jax_bbox.process_bounding_boxes(root / "bbox", csv_jax) == 2
    assert csv_port.read_text() == csv_jax.read_text()
    kw = dict(human_labels_file=root / "human.txt", bbox_csv=csv_port,
              num_shards=3, num_workers=1)
    got = imagenet.build_imagenet_tfrecords(
        root / "images", root / "synsets.txt", tmp_path / "port",
        "validation", device="cpu", **kw)
    want = jax_imagenet.build_imagenet_tfrecords(
        root / "images", root / "synsets.txt", tmp_path / "jax",
        "validation", **kw)
    assert got == want == len(names) - 1
    _assert_same_shards(tmp_path / "port", tmp_path / "jax")
    err = capsys.readouterr().err
    assert f"skipped 1: {root / 'images' / names[7]} (" in err
    labels = {}
    for path in sorted((tmp_path / "port").iterdir()):
        for rec in read_records(path):
            f = decode_example(rec)
            name = f["image/filename"][0].decode()
            labels[name] = f["image/class/label"][0]
            size = Image.open(root / "images" / name).size
            assert (f["image/width"][0], f["image/height"][0]) == size
    assert labels == {n: WNIDS.index(n.split("_")[0]) + 1
                      for n in names[:7]}
    with pytest.raises(RuntimeError, match="CUDA"):
        imagenet.build_imagenet_tfrecords(root / "images",
                                          root / "synsets.txt",
                                          tmp_path / "x")


def test_spawned_pool_writes_the_same_shards(tree, tmp_path, capsys):
    """The spawn pool (2 workers) against this process's writer, the
    skipped file named by both."""
    root, names = tree
    for workers in (2, 1):
        imagenet.build_imagenet_tfrecords(
            root / "images", root / "synsets.txt", tmp_path / str(workers),
            "train", num_shards=2, num_workers=workers, device="cpu")
        assert f"skipped 1: {root / 'images' / names[7]} (" in \
            capsys.readouterr().err
    _assert_same_shards(tmp_path / "2", tmp_path / "1")


def _raw_gaps(port_dir: Path, jax_dir: Path) -> np.ndarray:
    """Shard names, counts, labels and sizes equal; -> every pixel's
    gap."""
    port, jax = _shards(port_dir), _shards(jax_dir)
    assert list(port) == list(jax)
    gaps = []
    for name in port:
        a = [decode_example(r) for r in read_records(port_dir / name)]
        b = [decode_example(r) for r in read_records(jax_dir / name)]
        assert len(a) == len(b)
        for fa, fb in zip(a, b):
            for key in ("image/class/label", "image/height", "image/width"):
                assert fa[key] == fb[key], key
            pa = np.frombuffer(fa["image/raw"][0], np.uint8).astype(int)
            pb = np.frombuffer(fb["image/raw"][0], np.uint8).astype(int)
            gaps.append(np.abs(pa - pb))
    return np.concatenate(gaps)


@pytest.mark.parametrize("source", ["fixtures", "tree"])
def test_raw_crops_equal_jax_within_the_decode_bounds(tree, tmp_path,
                                                      monkeypatch, source):
    """``fixtures``: the committed JPEG fixtures (``tests/data/``) against
    the JAX builder as it is, within ``test_torch_imagenet.py``'s decode
    bounds (tf's default fast IDCT against PIL's accurate one). ``tree``:
    this module's noise-textured files, on which tf's fast IDCT is up to
    7 steps off the accurate one, against the JAX builder with tf's
    decode switched to the accurate IDCT (then equal to PIL's pixels):
    what is left is the resize and the rounding, within 1 step."""
    import tensorflow as tf

    root, _ = tree
    images, synsets = root / "images", root / "synsets.txt"
    max_gap, mean_gap = 4, 1.5
    if source == "fixtures":
        images = tmp_path / "fixtures"
        images.mkdir()
        data = Path(__file__).parent / "data"
        for i, path in enumerate(sorted(data.glob("jpeg_*.jpg"))):
            shutil.copy(path, images / f"{WNIDS[i % 3]}_{i}.JPEG")
    else:
        monkeypatch.setattr(tf.io, "decode_jpeg", functools.partial(
            tf.io.decode_jpeg, dct_method="INTEGER_ACCURATE"))
        max_gap, mean_gap = 1, 0.01
    jpeg = tmp_path / "jpeg"
    n = imagenet.build_imagenet_tfrecords(images, synsets, jpeg, "train",
                                          num_shards=2, num_workers=1,
                                          device="cpu")
    got = raw_crops.build_raw_crops(jpeg, tmp_path / "port", stored=32,
                                    num_shards=2, num_workers=1,
                                    device="cpu")
    want = jax_raw.build_raw_crops(jpeg, tmp_path / "jax", stored=32,
                                   num_shards=2, num_workers=1)
    assert got == want == n
    assert json.loads((tmp_path / "port" / "raw-train.meta.json")
                      .read_text()) == json.loads(
        (tmp_path / "jax" / "raw-train.meta.json").read_text())
    gap = _raw_gaps(tmp_path / "port", tmp_path / "jax")
    assert gap.max() <= max_gap and gap.mean() <= mean_gap, (
        gap.max(), gap.mean())


def _voc_tree(root: Path, rng) -> None:
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (root / sub).mkdir(parents=True)
    names = [f"00000{i}" for i in range(4)]
    for i, name in enumerate(names):
        img = Image.fromarray(_smooth(rng, 48, 64))
        _save(img.convert("L") if i == 2 else img,
              root / "JPEGImages" / f"{name}.jpg", "JPEG", quality=90)
        objects = "".join(
            f"<object><name>{cls}</name><bndbox><xmin>{x}</xmin><ymin>5"
            f"</ymin><xmax>{x + 20}</xmax><ymax>70</ymax></bndbox>"
            "</object>"
            for cls, x in (("dog", 4 + i), ("person", 40))[:i % 2 + 1])
        (root / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><filename>{name}.jpg</filename><size><width>64"
            f"</width><height>48</height></size>{objects}</annotation>")
    (root / "ImageSets/Main/train.txt").write_text("\n".join(names) + "\n")


def test_voc_and_coco_builders_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    _voc_tree(tmp_path / "voc", rng)
    assert detection.parse_voc_xml(
        tmp_path / "voc/Annotations/000001.xml") == \
        jax_detection.parse_voc_xml(tmp_path / "voc/Annotations/000001.xml")
    got = detection.build_voc_tfrecords(tmp_path / "voc", tmp_path / "p",
                                        num_shards=2, num_workers=1,
                                        device="cpu")
    want = jax_detection.build_voc_tfrecords(tmp_path / "voc",
                                             tmp_path / "j", num_shards=2,
                                             num_workers=1)
    assert got == want == 4
    _assert_same_shards(tmp_path / "p", tmp_path / "j")
    images = tmp_path / "voc" / "JPEGImages"
    coco = {"categories": [{"id": 18, "name": "dog"},
                           {"id": 1, "name": "person"}],
            "images": [{"id": i, "file_name": f"00000{i}.jpg", "width": 64,
                        "height": 48} for i in range(3)],
            "annotations": [
                {"image_id": 0, "category_id": 18, "bbox": [2, 3, 20, 30]},
                {"image_id": 0, "category_id": 1, "bbox": [40, 1, 30, 50]},
                {"image_id": 1, "category_id": 1, "bbox": [5, 5, 5, 5],
                 "iscrowd": 1},
                {"image_id": 2, "category_id": 18, "bbox": [0, 0, 64, 48]}]}
    (tmp_path / "coco.json").write_text(json.dumps(coco))
    got = detection.build_coco_tfrecords(images, tmp_path / "coco.json",
                                         tmp_path / "pc", num_shards=2,
                                         num_workers=1, device="cpu")
    want = jax_detection.build_coco_tfrecords(images, tmp_path / "coco.json",
                                              tmp_path / "jc", num_shards=2,
                                              num_workers=1)
    assert got == want == 3
    _assert_same_shards(tmp_path / "pc", tmp_path / "jc")


def test_mpii_builder_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    (tmp_path / "img").mkdir()
    anns = []
    for i in range(3):
        img = Image.fromarray(_smooth(rng, 60, 44))
        fmt = "PNG" if i == 1 else "JPEG"  # a PNG under a .jpg name
        _save(img, tmp_path / "img" / f"p{i}.jpg", fmt)
        joints = [{"id": j, "x": float(rng.uniform(-3, 44)),
                   "y": float(rng.uniform(0, 60)), "visible": j % 2}
                  for j in range(16) if j != 5]
        anns.append({"image": f"p{i}.jpg", "joints": joints,
                     "center": [20.0 + i, 30.0], "scale": 1.5 + i})
    (tmp_path / "mpii.json").write_text(json.dumps(anns))
    got = pose.build_mpii_tfrecords(tmp_path / "img", tmp_path / "mpii.json",
                                    tmp_path / "p", num_shards=2,
                                    num_workers=1, device="cpu")
    want = jax_pose.build_mpii_tfrecords(tmp_path / "img",
                                         tmp_path / "mpii.json",
                                         tmp_path / "j", num_shards=2,
                                         num_workers=1)
    assert got == want == 3
    _assert_same_shards(tmp_path / "p", tmp_path / "j")


def test_cyclegan_builder_and_celeba_split_equal_jax(tmp_path):
    rng = np.random.default_rng(6)
    for split in ("trainA", "trainB", "testA"):
        (tmp_path / "gan" / split).mkdir(parents=True)
        for i in range(3):
            img = Image.fromarray(_smooth(rng, 32, 32))
            suffix, fmt = ((".png", "PNG") if i == 0 else (".jpg", "JPEG"))
            _save(img, tmp_path / "gan" / split / f"{i}{suffix}", fmt)
    (tmp_path / "gan" / "trainA" / "notes.txt").write_text("skipped")
    got = gan.build_cyclegan_tfrecords(tmp_path / "gan", tmp_path / "p",
                                       num_shards=2, num_workers=1,
                                       device="cpu")
    want = jax_gan.build_cyclegan_tfrecords(tmp_path / "gan", tmp_path / "j",
                                            num_shards=2, num_workers=1)
    assert got == want == {"trainA": 3, "trainB": 3, "testA": 3}
    _assert_same_shards(tmp_path / "p", tmp_path / "j")
    celeba = tmp_path / "celeba"
    celeba.mkdir()
    lines = ["5", "Smiling Male Young"]
    for i in range(5):
        (celeba / f"{i:06d}.jpg").write_bytes(b"x" * (i + 1))
        lines.append(f"{i:06d}.jpg 1 {1 if i % 2 else -1} -1")
    (tmp_path / "attrs.txt").write_text("\n".join(lines) + "\n")
    for mod, out in ((gan, "sp"), (jax_gan, "sj")):
        assert mod.split_celeba_by_attribute(
            celeba, tmp_path / "attrs.txt", tmp_path / out,
            limit_per_side=2) == (2, 2)
    for side in ("trainA", "trainB"):
        assert sorted(p.name for p in (tmp_path / "sp" / side).iterdir()) \
            == sorted(p.name for p in (tmp_path / "sj" / side).iterdir())


def test_builders_cli(tree, tmp_path, capsys):
    root, _ = tree
    assert builders_main(["bbox", str(root / "bbox"),
                          str(tmp_path / "b.csv")]) == 0
    assert json.loads(capsys.readouterr().out)["written"] == 2
    assert builders_main(["imagenet", str(root / "images"),
                          str(root / "synsets.txt"), str(tmp_path / "r"),
                          "--shards", "1", "--workers", "1", "--device",
                          "cpu"]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out)["written"] == 7
    assert "skipped 1" in out.err
    with pytest.raises(RuntimeError, match="CUDA"):
        builders_main(["voc", str(tmp_path), str(tmp_path / "v")])


# --------------------------------------------- transforms, folder dataset


def _transforms(mod, size):
    return [mod.Rescale(40), mod.RandomCrop(size), mod.CenterCrop(size),
            mod.RandomHorizontalFlip(), mod.ToFloat(), mod.EnsureRGB(),
            mod.ToUint8(), mod.ColorJitter(0.4, 0.4, 0.4),
            mod.Normalize((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))]


@pytest.mark.parametrize("with_cv2", [True, False])
def test_transforms_op_for_op_equal_jax(monkeypatch, with_cv2):
    if not with_cv2:
        monkeypatch.setattr(jax_T, "cv2", None)
        monkeypatch.setattr(T, "cv2", None)
    else:
        pytest.importorskip("cv2")
        assert T.load_cv2() is not None
    image = _smooth(np.random.default_rng(7), 45, 61)
    for seed in range(3):
        r_port, r_jax = (np.random.default_rng(seed) for _ in range(2))
        x_port = x_jax = image
        for ours, theirs in zip(_transforms(T, 32), _transforms(jax_T, 32)):
            x_port, x_jax = ours(r_port, x_port), theirs(r_jax, x_jax)
            np.testing.assert_array_equal(x_port, x_jax)
            assert x_port.dtype == x_jax.dtype
    for name in ("imagenet_train_transform", "imagenet_eval_transform",
                 "imagenet_host_transform"):
        a = getattr(T, name)(224)(np.random.default_rng(1), image)
        b = getattr(jax_T, name)(224)(np.random.default_rng(1), image)
        np.testing.assert_array_equal(a, b)


def test_folder_dataset_and_loader_equal_jax(tree, monkeypatch):
    """With cv2 (both decode with it), each sample and each batch of an
    epoch equal JAX's; without cv2 the port decodes with PIL (libjpeg's
    accurate IDCT, as cv2's), within 1 uint8 step of the JAX decode."""
    pytest.importorskip("cv2")
    root, names = tree
    d = root / "folder"
    if not d.exists():
        d.mkdir()
        for name in names[:2] + names[5:6]:  # RGB JPEGs, one progressive
            shutil.copy(root / "images" / name, d / name)
    tr, tj = T.imagenet_host_transform(32), jax_T.imagenet_host_transform(32)
    ours = folder.ImageNetFolderDataset(d, root / "synsets.txt", tr,
                                        seed=3, device="cpu")
    theirs = jax_folder.ImageNetFolderDataset(d, root / "synsets.txt", tj,
                                              seed=3)
    assert len(ours) == len(theirs) == 3
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    for i in range(3):
        a, b = ours.load(i, epoch=1), theirs.load(i, epoch=1)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    got = list(folder.FolderLoader(ours, 2, num_workers=1,
                                   drop_remainder=False).epoch(4))
    want = list(jax_folder.FolderLoader(theirs, 2, num_workers=1,
                                        drop_remainder=False).epoch(4))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for k in ("image", "label"):
            np.testing.assert_array_equal(a[k], b[k])
    raw = T.Compose([T.EnsureRGB()])
    plain = folder.ImageNetFolderDataset(d, root / "synsets.txt", raw,
                                         device="cpu")
    with_cv2 = [plain.load(i)[0].astype(int) for i in range(3)]
    monkeypatch.setattr(T, "cv2", None)
    for i in range(3):
        gap = np.abs(plain.load(i)[0].astype(int) - with_cv2[i])
        assert gap.max() <= 1, gap.max()
    with pytest.raises(RuntimeError, match="CUDA"):
        folder.ImageNetFolderDataset(d, root / "synsets.txt", raw)
