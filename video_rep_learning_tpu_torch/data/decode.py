"""Python binding for the native (FFmpeg C++) ranged video decoder.

The port's own copy of `video_rep_learning_tpu/data/decode.py` (the same
`native/` library, loaded with ctypes). It replaces the reference's decode
stack (SURVEY.md §2):
Decord `get_batch` (`utils/decord_loader.py:7-12`), torchvision `read_video`
(`penn_action.py:107,140`), and the OpenCV metadata probe
(`kinetics400.py:89-90`). The shared library is built from
`native/videodecode.cc` (`make -C native`); this module auto-builds it on
first use when a toolchain is available.

Also supports a `.npy` frame-store format ((T, H, W, 3) uint8) used by the
synthetic-data tests and the dataset-prep tools, so the full pipeline runs
without any codec dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvrl_decode.so")

_lib = None
_lib_lock = threading.Lock()


def _load_library():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                               capture_output=True)
            except Exception as e:  # pragma: no cover
                raise RuntimeError(
                    f"native decoder not built and build failed: {e}") from e
        lib = ctypes.CDLL(_LIB_PATH)
        lib.vrl_open.restype = ctypes.c_void_p
        lib.vrl_open.argtypes = [ctypes.c_char_p]
        lib.vrl_close.argtypes = [ctypes.c_void_p]
        lib.vrl_probe.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double)]
        lib.vrl_decode_range.restype = ctypes.c_int64
        lib.vrl_decode_range.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.vrl_encode_video.restype = ctypes.c_int
        lib.vrl_encode_video.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_double]
        lib.vrl_decode_image.restype = ctypes.c_int64
        lib.vrl_decode_image.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


class VideoReader:
    """Random-access frame reader. One instance per open video; not
    thread-safe across threads (use one per loader worker)."""

    def __init__(self, path: str):
        self.path = path
        self._npy: Optional[np.ndarray] = None
        self._handle = None
        if path.endswith(".npy"):
            self._npy = np.load(path, mmap_mode="r")
            self.num_frames = int(self._npy.shape[0])
            self.height = int(self._npy.shape[1])
            self.width = int(self._npy.shape[2])
            self.fps = 25.0
        else:
            lib = _load_library()
            self._handle = lib.vrl_open(path.encode())
            if not self._handle:
                raise IOError(f"cannot open video {path}")
            n = ctypes.c_int64()
            w = ctypes.c_int()
            h = ctypes.c_int()
            fps = ctypes.c_double()
            lib.vrl_probe(self._handle, ctypes.byref(n), ctypes.byref(w),
                          ctypes.byref(h), ctypes.byref(fps))
            self.num_frames = int(n.value)
            self.width = int(w.value)
            self.height = int(h.value)
            self.fps = float(fps.value)

    def decode_range(self, start: int, stop: int) -> np.ndarray:
        """Decode frames [start, stop) -> (stop-start, H, W, 3) uint8.
        Mirrors `decord_load(file, min, max+1)` (`utils/decord_loader.py`)."""
        if self._npy is not None:
            stop_c = min(stop, self.num_frames)
            out = np.asarray(self._npy[start:stop_c])
            if stop_c < stop:  # pad underrun with last frame, like the decoder
                pad = np.repeat(out[-1:], stop - stop_c, axis=0)
                out = np.concatenate([out, pad], axis=0)
            return np.ascontiguousarray(out)
        lib = _load_library()
        n = stop - start
        out = np.empty((n, self.height, self.width, 3), np.uint8)
        written = lib.vrl_decode_range(
            self._handle, start, stop,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if written < 0:
            raise IOError(f"decode error {written} on {self.path}[{start}:{stop}]")
        if written == 0:
            raise IOError(f"no frames decoded from {self.path}[{start}:{stop}]")
        if written < n:  # EOF underrun with nothing to pad from inside C
            out[written:] = out[written - 1]
        return out

    def read_all(self) -> np.ndarray:
        return self.decode_range(0, self.num_frames)

    def close(self):
        if self._handle is not None:
            _load_library().vrl_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def probe(path: str) -> Tuple[int, int, int, float]:
    """(num_frames, height, width, fps) — the cv2.VideoCapture probe parity
    (`kinetics400.py:89-90`)."""
    r = VideoReader(path)
    try:
        return r.num_frames, r.height, r.width, r.fps
    finally:
        r.close()


def decode_image(data: bytes) -> np.ndarray:
    """Decode one JPEG/PNG byte string to (H, W, 3) uint8 (offline dataset
    prep; TFRecord frames are stored as JPEGs)."""
    lib = _load_library()
    buf = np.frombuffer(data, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    src = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    needed = lib.vrl_decode_image(src, len(data), None, 0,
                                  ctypes.byref(w), ctypes.byref(h))
    if needed < 0:
        raise IOError(f"image decode failed ({needed})")
    out = np.empty((h.value, w.value, 3), np.uint8)
    ret = lib.vrl_decode_image(
        src, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        needed, ctypes.byref(w), ctypes.byref(h))
    if ret != needed:
        raise IOError(f"image decode failed ({ret})")
    return out


def encode_video(path: str, frames: np.ndarray, fps: float = 25.0) -> None:
    """Write (T, H, W, 3) uint8 frames to a video file (or .npy store)."""
    frames = np.ascontiguousarray(frames, np.uint8)
    if path.endswith(".npy"):
        np.save(path, frames)
        return
    lib = _load_library()
    t, h, w, c = frames.shape
    assert c == 3
    ret = lib.vrl_encode_video(
        path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t, h, w, fps)
    if ret != 0:
        raise IOError(f"encode failed ({ret}) for {path}")
