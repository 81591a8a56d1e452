"""The port's checkpoint file writer and its CRC-32, against numpy's and
zlib's: ``ckpt.checkpoint._write_npz`` writes what ``np.savez`` writes
(``zipfile`` and ``np.load`` read it, and every member's CRC-32 holds),
and ``crc32``, taken in pieces on threads, equals ``zlib.crc32`` of the
whole buffer.  Small pieces here make every buffer take that path."""
import zipfile
import zlib

import numpy as np
import pytest

from repro_torch.ckpt import checkpoint as ck


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1000, 4099])
def test_crc32_in_pieces_equals_zlib(monkeypatch, n):
    monkeypatch.setattr(ck, "CRC_PIECE", 64)
    buf = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert ck.crc32(buf) == zlib.crc32(buf)
    assert ck.crc32(buf, 0x1234ABCD) == zlib.crc32(buf, 0x1234ABCD)


def test_crc32_combine_joins_any_split():
    rng = np.random.default_rng(1)
    for n in (0, 1, 5, 300, 70000):
        buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for cut in {0, n // 3, n}:
            a, b = buf[:cut], buf[cut:]
            assert ck.crc32_combine(zlib.crc32(a), zlib.crc32(b),
                                    len(b)) == zlib.crc32(buf)


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "a0": rng.standard_normal((3, 5)).astype(np.float32),
        "a1": np.asarray(7, dtype=np.int64),                   # 0-d
        "a2": np.zeros((0, 4), np.float32),                    # empty
        "a3": rng.integers(0, 1 << 16, (40, 6)).astype(np.uint16),
        "a4": np.asfortranarray(rng.standard_normal((4, 3))),
        "a5": rng.standard_normal((8, 3))[::2],                # strided
        "a6": rng.standard_normal((33, 17)),
    }


def test_write_npz_reads_as_np_savez_writes(monkeypatch, tmp_path):
    monkeypatch.setattr(ck, "CRC_PIECE", 16)
    arrays = _arrays()
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "np.npz")
    ck._write_npz(ours, arrays)
    np.savez(theirs, **arrays)
    with zipfile.ZipFile(ours) as z, zipfile.ZipFile(theirs) as w:
        assert z.testzip() is None
        assert z.namelist() == w.namelist()
        for name in w.namelist():
            assert z.getinfo(name).file_size == w.getinfo(name).file_size
    with np.load(ours) as z, np.load(theirs) as w, open(ours, "rb") as f:
        for k, a in arrays.items():
            assert z[k].dtype == a.dtype and z[k].shape == a.shape
            np.testing.assert_array_equal(z[k], a)
            np.testing.assert_array_equal(z[k], w[k])
            got = ck._read_stored(ours, f, z.zip.getinfo(k + ".npy"))
            np.testing.assert_array_equal(got, a)


def test_write_npz_crc_catches_a_flipped_byte(tmp_path):
    path = str(tmp_path / "w.npz")
    arr = np.arange(1000, dtype=np.float32)
    ck._write_npz(path, {"a0": arr})
    with zipfile.ZipFile(path) as z:
        info = z.getinfo("a0.npy")
    raw = bytearray(open(path, "rb").read())
    raw[info.header_offset + 30 + len("a0.npy") + 20 + 200] ^= 1
    open(path, "wb").write(bytes(raw))
    with np.load(path) as z, open(path, "rb") as f:
        with pytest.raises(zipfile.BadZipFile):
            ck._read_stored(path, f, z.zip.getinfo("a0.npy"))
