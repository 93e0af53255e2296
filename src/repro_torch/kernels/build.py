"""Build and load the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, bound with ``ctypes``.

The library is built at first use from ``csrc/*.cu`` into ``_build/``
beside this file (listed in ``.gitignore``), under a name that carries
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as built.  A failed build raises with the
compiler's message; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = [
    "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "build_info", "check", "load_library",
    "nvcc_path",
]

_HERE = pathlib.Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "partial_reduce.cu",)
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
_info: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "repro_torch CUDA kernels are built from source at first use"
    )


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pr_error_string.argtypes = [i]
    lib.pr_error_string.restype = ctypes.c_char_p
    lib.pr_two_pass.argtypes = [i, p, p, p, p, i, i, i, i, i, i, p, p, p]
    lib.pr_two_pass.restype = i
    lib.pr_fused_scan.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, p, p, p]
    lib.pr_fused_scan.restype = i
    lib.pr_merge.argtypes = [p, p, i, i, i, p, p, p]
    lib.pr_merge.restype = i


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256()
        for src in SOURCES:
            digest.update(src.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"libpartial_reduce_{digest.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, out)
            _info.update(
                build_s=time.perf_counter() - t0, command=" ".join(cmd),
                ptxas=proc.stderr.strip(),
            )
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _info["library"] = str(out)
        _lib = lib
        return lib


def build_info() -> dict:
    """Build time, command and ``ptxas -v`` report of this process's build
    (empty before ``load_library``; no build fields if it was cached)."""
    return dict(_info)


def ptxas_table(report: str) -> list:
    """Per kernel of a ``ptxas -v`` report, in its order: the mangled
    name, registers, and spill stores and loads in bytes.

    >>> ptxas_table('''ptxas info    : Function properties for _Z1kv
    ...     16 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
    ... ptxas info    : Used 80 registers, used 1 barriers''')
    [{'kernel': '_Z1kv', 'registers': 80, 'spill_stores': 12, 'spill_loads': 16}]
    """
    rows, current = [], None
    for line in report.splitlines():
        if "Function properties for " in line:
            current = {"kernel": line.split("Function properties for ")[1].strip(),
                       "registers": None, "spill_stores": 0, "spill_loads": 0}
            rows.append(current)
        elif current is not None and "spill stores" in line:
            words = line.replace(",", "").split()
            current["spill_stores"] = int(words[words.index("spill") - 2])
            current["spill_loads"] = int(words[-4])
        elif current is not None and "Used " in line and " registers" in line:
            current["registers"] = int(line.split("Used ")[1].split()[0])
    return rows


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise with the CUDA (or argument) error a C entry point returned."""
    if code != 0:
        raise RuntimeError(
            f"{what} failed: {lib.pr_error_string(code).decode()} ({code})"
        )


def main(argv=None) -> int:
    """``python -m repro_torch.kernels.build [SOURCE.cu ...]``: compile the
    sources (default: this package's) with ``NVCC_FLAGS`` into a scratch
    library under ``BUILD_DIR`` and print each kernel's registers and
    spills, one JSON object a line; for comparing two versions of a
    kernel source."""
    import json
    import sys

    sources = (argv if argv is not None else sys.argv[1:]) or list(map(str, SOURCES))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"report.{os.getpid()}.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(out), *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.unlink(missing_ok=True)
    if proc.returncode != 0:
        print(proc.stdout, proc.stderr, file=sys.stderr)
        return proc.returncode
    for row in ptxas_table(proc.stderr):
        print(json.dumps({"sources": sources, **row}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
