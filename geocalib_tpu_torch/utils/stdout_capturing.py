"""Tee stdout/stderr to a log file.

Port of geocalib_tpu/utils/stdout_capturing.py: a pure-Python tee that starts
no process, so that it is safe under torchrun (each rank may capture its own
log).
"""

import contextlib
import sys
from pathlib import Path
from typing import IO


class _Tee:
    def __init__(self, stream: IO, fh: IO):
        self._stream = stream
        self._fh = fh

    def write(self, data: str) -> int:
        self._fh.write(data)
        return self._stream.write(data)

    def flush(self) -> None:
        self._fh.flush()
        self._stream.flush()

    def __getattr__(self, name):
        return getattr(self._stream, name)


@contextlib.contextmanager
def capture_outputs(path):
    """Mirror stdout/stderr into `path` (appended) for the duration of the block."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as fh:
        out, err = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = _Tee(out, fh), _Tee(err, fh)
        try:
            yield
        finally:
            sys.stdout, sys.stderr = out, err
