"""Native (C) host-side components of the port, loaded via ctypes.

Each component is compiled at first use with the system C compiler into
`build/smoltts_torch/` at the repository root (beside the CUDA library),
named by a hash of its source and flags, so a changed source rebuilds and an
unchanged one loads at once. Importing the package builds nothing. Without a
C toolchain a component is unavailable and callers take their numpy / scipy
path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "smoltts_torch"

_CACHE: dict = {}
_LOCK = threading.Lock()


def build_native_lib(src: Path, name: str, extra_flags=()) -> Optional[ctypes.CDLL]:
    """Compile `src` into a cached shared object and dlopen it; None (cached)
    when no C toolchain is present."""
    key = (str(src), name)
    with _LOCK:
        if key in _CACHE:
            return _CACHE[key]
        flags = ["-O2", "-shared", "-fPIC", *extra_flags]
        digest = hashlib.sha256(" ".join(flags).encode() + src.read_bytes()).hexdigest()[:16]
        so_path = BUILD_DIR / f"libsmoltts_{name}_{digest}.so"
        try:
            if not so_path.exists():
                # Compile to a private temp path, then publish atomically:
                # concurrent processes (pytest-xdist workers) may race this
                # build, and `cc -o` writing the file another process is
                # dlopen()ing would hand out a torn .so.
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["cc", *flags, str(src), "-o", str(tmp)], check=True,
                               capture_output=True)
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(str(so_path))
        except (OSError, subprocess.CalledProcessError):
            lib = None
        _CACHE[key] = lib
        return lib
