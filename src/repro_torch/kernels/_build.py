"""Build the hand-written CUDA kernels at first use, and count their launches.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` into ``build/repro_torch_kernels/lib<name>-<hash>.so`` at the root
of the checkout, where ``<hash>`` is the source's content hash, so an edit
rebuilds and an unchanged source is reused.  The library is loaded with
``ctypes``.  :func:`build_all` starts one ``nvcc`` per source, all at once.

Launch counters are integers under a lock of their own (threads launch at
once: the fleet's workers, a server beside a live index's writer): each
wrapper calls :func:`count` right where it launches its kernel, and nowhere
else.  While a tracer is enabled, each kNN call also leaves one record
(:func:`record_knn`: K4's wrapper on the card, ``ops.knn``'s plain path on
the CPU), read by :func:`knn_launches` for the benchmark's roofline share
of K4.  Each ``nvcc`` run is reported to :data:`on_build`, a hook that
:func:`repro_torch.telemetry.install_compile_listener` installs (this module
imports nothing of telemetry).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("distance", "knn", "beam", "attention", "merge")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = {
    "pairwise_distance": 0,
    "pairwise_distance_u8": 0,
    "fused_beam": 0,
    "knn": 0,
    "flash_attention": 0,
    "flash_decode": 0,
    "merge_rows": 0,
}

# K4's calls while a tracer is enabled: (m, n, d, k, seconds), the seconds
# a float (the plain path's wall time) or the pair of CUDA events recorded
# around the launch, resolved by knn_launches().  Only the benchmark's
# window reads it, after a reset_counts(); a long-lived traced process
# keeps just the newest KNN_RECORD_CAP calls.
KNN_RECORD_CAP = 4096
_KNN_RECORD: collections.deque = collections.deque(maxlen=KNN_RECORD_CAP)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()  # held through nvcc builds
_COUNT_LOCK = threading.Lock()  # held for one increment

# called as on_build(source, seconds) after every nvcc run, failed ones too
on_build = None


def count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def reset_counts() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        _KNN_RECORD.clear()


def record_knn(m: int, n: int, d: int, k: int, seconds) -> None:
    with _COUNT_LOCK:
        _KNN_RECORD.append((m, n, d, k, seconds))


def knn_launches() -> list:
    """``(m, n, d, k, seconds)`` of each K4 call recorded since
    :func:`reset_counts`, the newest :data:`KNN_RECORD_CAP` of them; a
    launch's CUDA events are waited for here."""
    with _COUNT_LOCK:
        recs = list(_KNN_RECORD)
    out = []
    for m, n, d, k, s in recs:
        if isinstance(s, tuple):
            s[1].synchronize()
            s = s[0].elapsed_time(s[1]) / 1e3
        out.append((m, n, d, k, s))
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library in parallel; returns each source's
    compiler output (registers, shared memory, spills) by name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs: dict[str, str] = {}
    with _LOCK:
        t0 = time.perf_counter()
        running = [(n, *_start(n)) for n in names
                   if n not in _LIBS and not _lib_path(n).exists()]
        failed = []
        for name, proc, tmp, out in running:
            log, _ = proc.communicate()
            logs[name] = log
            if on_build is not None:  # all start at t0, each ends by now
                on_build(name, time.perf_counter() - t0)
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise on a launch that the runtime refused (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
