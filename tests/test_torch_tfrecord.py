"""The port's TFRecord codec against the JAX package's, on the CPU.

The compiled CRC32C (``csrc/crc32c.cpp``, built here by the system C++
compiler), its plain Python twin and the JAX package's ``crc32c``
(``google_crc32c`` where it is installed) agree exactly on random buffers
of 0 to 64 bytes at every offset 0-7 (unaligned slices) and on
record-sized ones. Records and examples cross both ways between the two
packages' writers and readers. A flipped byte in a record's length, its
CRCs or its payload, or a truncated file, raises ``DataLossError``.
"""

import struct

import numpy as np
import pytest

from deepvision_tpu.data import tfrecord as jax_tfrecord
from deepvision_tpu_torch.data import tfrecord
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)


@pytest.mark.parametrize("lengths", [range(0, 17), range(17, 41),
                                     range(41, 65)])
def test_compiled_plain_and_jax_crc32c_agree_on_small_unaligned_buffers(
        lengths):
    rng = np.random.default_rng(lengths.start)
    for n in lengths:
        buf = rng.bytes(n + 8)
        for off in range(8):
            view = memoryview(buf)[off:off + n]
            want = jax_tfrecord.crc32c(bytes(view))
            assert tfrecord.crc32c(view) == want, (n, off)
            assert tfrecord.crc32c_reference(view) == want, (n, off)


@pytest.mark.parametrize("n", [4096 + 3, 256 * 341 * 3])
def test_crc32c_agrees_on_record_sized_buffers(n):
    data = np.random.default_rng(n).bytes(n)
    want = jax_tfrecord.crc32c(data)
    assert tfrecord.crc32c(data) == want
    assert tfrecord.crc32c(bytearray(data)) == want
    assert tfrecord.crc32c(np.frombuffer(data, np.uint8)[1:]) \
        == jax_tfrecord.crc32c(data[1:])
    if n < 10_000:  # the plain twin: about 45 ms for the larger one
        assert tfrecord.crc32c_reference(data) == want


def test_known_crc32c_values():
    # RFC 3720 B.4: 32 zero bytes, 32 bytes of 0xFF, 0..31
    assert tfrecord.crc32c(bytes(32)) == 0x8A9136AA
    assert tfrecord.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert tfrecord.crc32c(bytes(range(32))) == 0x46DD794E
    assert tfrecord.crc32c(b"") == tfrecord.crc32c_reference(b"") == 0


def _records(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(0, 300))) for _ in range(n)]


@pytest.mark.parametrize("writer,reader", [
    (tfrecord.write_records, jax_tfrecord.read_records),
    (jax_tfrecord.write_records, tfrecord.read_records),
    (tfrecord.write_records, tfrecord.read_records)])
def test_records_cross_between_the_packages(tmp_path, writer, reader):
    records = _records()
    writer(tmp_path / "r.tfrecord", records)
    assert list(reader(tmp_path / "r.tfrecord", verify=True)) == records


def test_files_are_byte_identical(tmp_path):
    records = _records(seed=1)
    tfrecord.write_records(tmp_path / "a", records)
    jax_tfrecord.write_records(tmp_path / "b", records)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def _example():
    return {"image/encoded": [b"\xff\xd8 not really a jpeg"],
            "image/class/label": [417],
            "image/height": [256], "image/width": [341],
            "bbox": jax_tfrecord.FloatList([0.25, 0.5]),
            "neg": [-3], "name": ["n01440764"],
            "empty": jax_tfrecord.Int64List([])}


def test_examples_cross_between_the_packages():
    ours = {k: (tfrecord.FloatList(v) if isinstance(v, jax_tfrecord.FloatList)
                else tfrecord.Int64List(v)
                if isinstance(v, jax_tfrecord.Int64List) else v)
            for k, v in _example().items()}
    blob = tfrecord.encode_example(ours)
    assert blob == jax_tfrecord.encode_example(_example())
    want = jax_tfrecord.decode_example(blob)
    got = tfrecord.decode_example(blob)
    assert got == want
    assert got["image/class/label"] == [417] and got["neg"] == [-3]
    assert got["empty"] == []


@pytest.mark.parametrize("where", ["length", "length_crc", "payload",
                                   "payload_crc"])
def test_a_flipped_byte_raises(tmp_path, where):
    path = tmp_path / "r.tfrecord"
    tfrecord.write_records(path, [b"abcdefgh" * 8, b"second"])
    raw = bytearray(path.read_bytes())
    at = {"length": 0, "length_crc": 8, "payload": 12 + 20,
          "payload_crc": 12 + 64}[where]
    raw[at] ^= 0x01
    path.write_bytes(bytes(raw))
    with pytest.raises(tfrecord.DataLossError):
        list(tfrecord.read_records(path, verify=True))
    # without verification only a broken length can still be noticed
    if where.endswith("crc") or where == "payload":
        assert len(list(tfrecord.read_records(path, verify=False))) == 2


def test_a_truncated_file_raises(tmp_path):
    path = tmp_path / "r.tfrecord"
    tfrecord.write_records(path, [b"x" * 100])
    raw = path.read_bytes()
    for cut in (4, 10, 50, len(raw) - 1):
        path.write_bytes(raw[:cut])
        with pytest.raises(tfrecord.DataLossError, match="truncated"):
            list(tfrecord.read_records(path))
    path.write_bytes(raw + struct.pack("<Q", 5)[:3])
    with pytest.raises(tfrecord.DataLossError, match="truncated"):
        list(tfrecord.read_records(path))
