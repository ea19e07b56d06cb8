"""Native (C++) runtime components, built lazily with the system toolchain.

The port's own copy of :mod:`pde_tpu.native`: each component is a small
shared library compiled on first use from the sources in this directory into
``_build/`` beside them, keyed on the sources' modification time. A build
writes a temporary file and renames it into place while it holds a file lock,
so processes that build at once (test workers on a fresh tree) wait for one
build and load a whole library.
"""

from __future__ import annotations

import fcntl
import logging
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_HERE, "_build")
_LOCK = threading.Lock()
_logger = logging.getLogger(__name__)


def _up_to_date(out: str, sources: list[str]) -> bool:
    newest = max(os.path.getmtime(s) for s in sources)
    return os.path.exists(out) and os.path.getmtime(out) >= newest


def build_library(name: str, sources: list[str], libs: list[str]) -> str | None:
    """Compile ``sources`` into ``_build/lib<name>.so`` and return its path.

    Returns ``None`` (after logging) when the toolchain or a linked library
    is unavailable: callers treat that as "native component absent", as
    optional Python dependencies are handled.
    """
    out = os.path.join(_BUILD_DIR, f"lib{name}.so")
    srcs = [os.path.join(_HERE, s) for s in sources]
    with _LOCK:
        try:
            if _up_to_date(out, srcs):
                return out
            os.makedirs(_BUILD_DIR, exist_ok=True)
            with open(os.path.join(_BUILD_DIR, f"lib{name}.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if _up_to_date(out, srcs):  # another process built it meanwhile
                    return out
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = (["g++", "-O2", "-shared", "-fPIC", "-o", tmp] + srcs
                       + [f"-l{lib}" for lib in libs])
                res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True, timeout=120)
                if res.returncode != 0:
                    _logger.warning("building native %s failed:\n%s", name, res.stdout)
                    if os.path.exists(tmp):
                        os.remove(tmp)
                    return None
                os.replace(tmp, out)
                return out
        except (OSError, subprocess.SubprocessError) as err:
            _logger.warning("building native %s failed: %s", name, err)
            return None
