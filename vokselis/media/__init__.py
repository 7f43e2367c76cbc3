"""Host-side media IO: PNG screenshots, ffmpeg video, recorder worker thread.

Mirrors the reference's screenshot/video capture design (SURVEY.md H8/H9/H14):
a worker thread consumes frames from the render loop; screenshots become PNGs
(``png`` crate -> :mod:`vokselis.media.png`, with a native C++ fast path),
video frames are piped into an ffmpeg child process when ffmpeg exists
(src/utils/recorder.rs:79-127) and degrade to nothing when it doesn't
(src/utils/recorder.rs:62-71).
"""

from vokselis.media.png import write_png
from vokselis.media.recorder import Recorder, RecordEvent

__all__ = ["write_png", "Recorder", "RecordEvent"]
