"""Video-recording pipeline test with a stubbed ffmpeg.

The real environment has no ffmpeg; the reference degrades gracefully then
(recorder.rs:62-71, covered by test_media). This test installs a fake
``ffmpeg`` on PATH that drains stdin to a file, verifying the full F12
record flow: probe -> spawn -> raw RGBA frames down the pipe -> finish.
"""

import os
import stat
import time

import numpy as np
import pytest

FAKE_FFMPEG = """#!/bin/sh
# fake ffmpeg: last arg is the output path; drain stdin into <out>.raw
for out; do :; done
cat > "$out.raw"
"""


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    ff = bindir / "ffmpeg"
    ff.write_text(FAKE_FFMPEG)
    ff.chmod(ff.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.chdir(tmp_path)
    return bindir


@pytest.mark.parametrize("backend", ["python", "native"])
def test_video_frames_reach_ffmpeg(fake_ffmpeg, backend):
    from vokselis.media.recorder import Recorder
    from vokselis.utils.misc import ImageDimensions

    if backend == "native":
        from vokselis.native import get_lib

        if get_lib() is None:
            pytest.skip("native library unavailable")
    rec = Recorder(backend=backend)
    assert rec.backend == backend
    assert rec.ffmpeg_installed
    dims = ImageDimensions.new(32, 16)
    rec.start(dims)
    assert rec.is_recording
    frames = [
        np.full((16, 32, 4), i * 10, np.uint8) for i in range(3)
    ]
    for f in frames:
        rec.record(f)
    rec.close()

    recordings = os.listdir("recordings")
    raws = [f for f in recordings if f.endswith(".raw")]
    assert raws, f"no raw capture in {recordings}"
    data = open(os.path.join("recordings", raws[0]), "rb").read()
    expected = b"".join(f.tobytes() for f in frames)
    assert data == expected


def test_resize_mid_recording_finishes_video(fake_ffmpeg):
    """lib.rs:109-113: a resize stops an active recording."""
    from vokselis.engine.context import Context
    from vokselis.engine.loop import run
    from vokselis.models.trig import TrigDemo

    events = [
        {"type": "key", "key": "f12", "pressed": True},
        None,
        {"type": "resize", "width": 48, "height": 32},
        None,
    ]
    run(
        TrigDemo, width=32, height=16, frames=3,
        events=iter(events), quiet=True,
        context=Context(width=32, height=16, backbuffer_resolution=(32, 16)),
    )
    time.sleep(0.3)
    raws = [f for f in os.listdir("recordings") if f.endswith(".raw")]
    assert raws  # the recording was started and finished (by the resize)
