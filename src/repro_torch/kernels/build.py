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
    "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "build_info", "check",
    "cuobjdump_path", "load_library", "nvcc_path", "ptxas_table", "report",
    "sass_counts",
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
    lib.pr_two_pass.argtypes = [i, i, p, p, p, p, i, i, i, i, i, i, i, p, p, p]
    lib.pr_two_pass.restype = i
    lib.pr_fused_scan.argtypes = [i, i, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p]
    lib.pr_fused_scan.restype = i
    lib.pr_merge.argtypes = [p, p, i, i, i, p, p, p]
    lib.pr_merge.restype = i
    lib.pr_scan_plan.argtypes = [i, i, i, i, i, p, p]
    lib.pr_scan_plan.restype = i
    lib.pr_merge_plan.argtypes = [i, i, p, p, p]
    lib.pr_merge_plan.restype = i
    lib.pr_empty.argtypes = [p]
    lib.pr_empty.restype = i


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
    name, registers, its stack frame (local arrays) and spill stores and
    loads in bytes, and static shared memory in bytes (the scan kernel's
    is dynamic, sized at launch: ``kernels.partial_reduce.scan_smem``).

    >>> ptxas_table('''ptxas info    : Function properties for _Z1kv
    ...     16 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
    ... ptxas info    : Used 80 registers, used 1 barriers, 64 bytes smem''')
    [{'kernel': '_Z1kv', 'registers': 80, 'stack': 16, 'spill_stores': 12, 'spill_loads': 16, 'smem': 64}]
    """
    rows, current = [], None
    for line in report.splitlines():
        if "Function properties for " in line:
            current = {"kernel": line.split("Function properties for ")[1].strip(),
                       "registers": None, "stack": 0, "spill_stores": 0,
                       "spill_loads": 0, "smem": 0}
            rows.append(current)
        elif current is not None and "spill stores" in line:
            words = line.replace(",", "").split()
            current["stack"] = int(words[0])
            current["spill_stores"] = int(words[words.index("spill") - 2])
            current["spill_loads"] = int(words[-4])
        elif current is not None and "Used " in line and " registers" in line:
            current["registers"] = int(line.split("Used ")[1].split()[0])
            words = line.replace(",", "").split()
            if "smem" in words:
                current["smem"] = int(words[words.index("smem") - 2])
    return rows


def sass_counts(listing: str, opcode: str = "HGMMA") -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing: how many of its
    instructions are ``opcode`` (by default the tensor-core ``HGMMA``).

    >>> sass_counts('''\tFunction : _Z1av
    ...   /*0010*/  HGMMA.64x64x16.F32.BF16 R24, R152, gdesc[UR4], R24 ;
    ...   /*0020*/  HGMMA.64x64x16.F32.BF16 R24, R156, gdesc[UR8], R24 ;
    ... \tFunction : _Z1bv
    ...   /*0010*/  FFMA R1, R2, R3, R1 ;''')
    {'_Z1av': 2, '_Z1bv': 0}
    """
    counts, current = {}, None
    for line in listing.splitlines():
        if "Function : " in line:
            current = line.split("Function : ")[1].strip()
            counts[current] = 0
        elif current is not None and f" {opcode}" in line:
            counts[current] += 1
    return counts


def cuobjdump_path() -> str:
    """``cuobjdump`` beside ``nvcc``."""
    return str(pathlib.Path(nvcc_path()).with_name("cuobjdump"))


def report(library: str, ptxas: str) -> list:
    """Per kernel of a build: ptxas's registers, spills and static shared
    memory, its ptxas warnings and performance notes (a serialized wgmma
    pipeline, say), and the HGMMA instructions in its SASS."""
    proc = subprocess.run([cuobjdump_path(), "-sass", library],
                          capture_output=True, text=True, check=True)
    hgmma = sass_counts(proc.stdout)
    warnings = [line.strip() for line in ptxas.splitlines()
                if "warning" in line.lower() or "Performance" in line]
    rows = ptxas_table(ptxas)
    for row in rows:
        row["hgmma"] = hgmma.get(row["kernel"])
        row["warnings"] = [w for w in warnings if row["kernel"] in w]
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
    library under ``BUILD_DIR`` and print each kernel's registers,
    spills, static shared memory, ptxas warnings and HGMMA count
    (:func:`report`), one JSON object a line; for comparing two versions
    of a kernel source."""
    import json
    import sys

    sources = (argv if argv is not None else sys.argv[1:]) or list(map(str, SOURCES))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"report.{os.getpid()}.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(out), *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_s = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout, proc.stderr, file=sys.stderr)
        return proc.returncode
    try:
        rows = report(str(out), proc.stderr)
    finally:
        out.unlink(missing_ok=True)
    for row in rows:
        print(json.dumps({"sources": sources, "build_s": round(build_s, 1), **row}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
