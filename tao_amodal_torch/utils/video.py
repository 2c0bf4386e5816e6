"""Video writing and probing.

Port of :mod:`tao_amodal_tpu.utils.video` (the reference's ffmpeg context
manager, ``visualization/tao/utils/video.py:30-52``): even dimensions and
yuv420p output for players, and a ``video_info`` probe.  The backends keep
the JAX package's order, each imported only when tried: imageio-ffmpeg,
then ``cv2.VideoWriter``, then a directory of PNG frames, which the port
writes with PIL (the JAX package with ``cv2.imwrite``; the decoded pixels
are equal).  A path without a video extension is a frame directory.
"""

from __future__ import annotations

import contextlib
import os

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".gif")


class _FrameDirWriter:
    def __init__(self, path, fps):
        # A video-extension path means a fallback for a failed video
        # backend: write next to it; an extension-less path IS the
        # requested frame directory.
        root, ext = os.path.splitext(path)
        self.dir = root + "_frames" if ext else path
        os.makedirs(self.dir, exist_ok=True)
        self.count = 0

    def write_frame(self, frame):
        from PIL import Image

        Image.fromarray(frame).save(
            os.path.join(self.dir, f"{self.count:06d}.png"))
        self.count += 1

    def close(self):
        pass


class _Cv2Writer:
    def __init__(self, path, fps, size_wh):
        import cv2

        w, h = size_wh
        w -= w % 2
        h -= h % 2
        self._size = (w, h)
        self._writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not self._writer.isOpened():
            raise RuntimeError(f"cv2.VideoWriter failed for {path}")

    def write_frame(self, frame):
        import cv2

        w, h = self._size
        if frame.shape[1] != w or frame.shape[0] != h:
            frame = cv2.resize(frame, (w, h))
        self._writer.write(frame[:, :, ::-1])  # RGB -> BGR

    def close(self):
        self._writer.release()


class _ImageioWriter:
    def __init__(self, path, fps):
        import imageio

        self._writer = imageio.get_writer(
            path, fps=fps, codec="libx264", pixelformat="yuv420p",
            macro_block_size=2)

    def write_frame(self, frame):
        self._writer.append_data(frame)

    def close(self):
        self._writer.close()


@contextlib.contextmanager
def video_writer(path, fps=30, size_wh=None):
    """Context manager yielding an object with ``write_frame(rgb)``.

    Frames are RGB uint8; a video's dimensions are snapped to even values
    (yuv420p, reference ``video.py:33-35``).
    """
    writer = None
    if os.path.splitext(path)[1].lower() in VIDEO_EXTENSIONS:
        try:
            writer = _ImageioWriter(path, fps)
        except Exception:
            if size_wh is not None:
                try:
                    writer = _Cv2Writer(path, fps, size_wh)
                except Exception:
                    writer = None
    if writer is None:
        writer = _FrameDirWriter(path, fps)
    try:
        yield writer
    finally:
        writer.close()


def video_info(path):
    """fps, frame count and size of a video file (reference
    ``video_info``); needs cv2, imported here."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        return {
            "fps": cap.get(cv2.CAP_PROP_FPS),
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        }
    finally:
        cap.release()
