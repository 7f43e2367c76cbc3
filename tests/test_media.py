"""Tests for the media pipeline: PNG codec, recorder worker, dimension math."""

import os
import time

import numpy as np

from vokselis.media.png import encode_png, read_png, write_png
from vokselis.utils.misc import ContinuousDict, ImageDimensions


class TestPng:
    def test_roundtrip_rgba(self, tmp_path):
        img = np.random.default_rng(1).integers(0, 255, (31, 17, 4), dtype=np.uint8)
        p = str(tmp_path / "t.png")
        write_png(p, img)
        back = read_png(p)
        np.testing.assert_array_equal(img, back)

    def test_roundtrip_rgb_and_grey(self, tmp_path):
        for shape in [(8, 8, 3), (8, 8)]:
            img = np.random.default_rng(2).integers(0, 255, shape, dtype=np.uint8)
            p = str(tmp_path / "t.png")
            write_png(p, img)
            back = read_png(p)
            np.testing.assert_array_equal(img.reshape(back.shape), back)

    def test_signature(self):
        data = encode_png(np.zeros((2, 2, 4), np.uint8))
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        assert b"IHDR" in data and b"IDAT" in data and b"IEND" in data

    def test_reads_reference_goldens(self):
        # decode the reference repo's golden images if present
        ref = "/root/reference/volume.png"
        if not os.path.isfile(ref):
            return
        img = read_png(ref)
        assert img.ndim == 3 and img.shape[2] in (3, 4)
        assert img.shape[0] > 100


class TestRecorder:
    def test_screenshot_worker(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        from vokselis.media.recorder import Recorder

        rec = Recorder()
        frame = np.random.default_rng(0).integers(0, 255, (16, 16, 4), dtype=np.uint8)
        rec.screenshot(frame)
        rec.close()
        shots = os.listdir("screenshots")
        assert len(shots) == 1
        back = read_png(os.path.join("screenshots", shots[0]))
        np.testing.assert_array_equal(frame, back)

    def test_video_degrades_without_ffmpeg(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("PATH", "")  # hide ffmpeg if any
        from vokselis.media.recorder import Recorder

        rec = Recorder()
        assert not rec.ffmpeg_installed
        rec.start(ImageDimensions.new(16, 16))
        assert not rec.is_recording  # start is a no-op without ffmpeg
        rec.close()


class TestUtils:
    def test_image_dimensions_even_and_padded(self):
        d = ImageDimensions.new(1281, 721)
        assert d.width == 1280 and d.height == 720
        assert d.unpadded_bytes_per_row == 1280 * 4
        assert d.padded_bytes_per_row % 256 == 0
        assert d.linear_size() == d.padded_bytes_per_row * 720

    def test_image_dimensions_aligned_case(self):
        d = ImageDimensions.new(64, 64)
        assert d.padded_bytes_per_row == 64 * 4  # already aligned

    def test_continuous_dict(self):
        m = ContinuousDict()
        m.push_value("a", 1)
        m.push_value("a", 2)
        m.push_value("b", 3)
        assert m["a"] == [1, 2] and m["b"] == [3]
