"""Build and load the hand-written CUDA kernels of ``garfield_tpu_torch.ops``.

The sources under ``ops/csrc/`` have a plain C interface. At first use,
``nvcc`` compiles each into a shared library under ``ops/build/`` (listed in
``.gitignore``), named by a hash of its source and flags, and the library is
loaded with ``ctypes``. No PyTorch header is compiled, so a build takes
seconds. Nothing here runs at import time: the CPU test suite imports every
module on machines with no ``nvcc``.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["NVCC_FLAGS", "RowRemap", "build", "load"]

_HERE = pathlib.Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "build"

# -fmad=false: the kernels must round each multiply and add once, as the
# TPU kernels they replace do (coordinate.cu header). Never fast-math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

MAX_ROWS = 32  # GTT_MAX_ROWS in coordinate.cu


class RowRemap(ctypes.Structure):
    """Mirror of ``struct RowRemap`` in ``csrc/coordinate.cu``."""

    _fields_ = [
        ("rows", ctypes.c_void_p * MAX_ROWS),
        ("scale", ctypes.c_float * MAX_ROWS),
    ]


# Per source file: the C functions and their ctypes signatures.
_SIGNATURES = {
    "coordinate.cu": {
        "gtt_coordinate_median": [
            ctypes.POINTER(RowRemap), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ],
        "gtt_trimmed_mean": [
            ctypes.POINTER(RowRemap), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p,
        ],
    },
}

_lock = threading.Lock()
_loaded = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of garfield_tpu_torch.ops are built on first use on "
        "a machine with the CUDA toolkit"
    )


def _library_path(source):
    text = (_CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return _BUILD / f"lib{pathlib.Path(source).stem}-{digest}.so"


def _compile(source):
    """nvcc ``source`` into its hashed library path; returns (path, log)."""
    out = _library_path(source)
    if out.exists():
        return out, ""
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n{log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    (_BUILD / f"{out.stem}.log").write_text(log)
    return out, log


def build(sources=None):
    """Compile the given sources (default: every ``csrc/*.cu``) in parallel,
    one ``nvcc`` each. Returns ``{source: (seconds, ptxas log)}``."""
    sources = sorted(sources or _SIGNATURES)
    results, errors = {}, []

    def one(src):
        t0 = time.perf_counter()
        try:
            _, log = _compile(src)
            results[src] = (time.perf_counter() - t0, log)
        except (RuntimeError, OSError) as e:
            errors.append(e)

    threads = [threading.Thread(target=one, args=(s,)) for s in sources]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def load(source):
    """The ctypes library of ``source``, compiled on first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            path, _ = _compile(source)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.gtt_error_string.argtypes = [ctypes.c_int]
            lib.gtt_error_string.restype = ctypes.c_char_p
            _loaded[source] = lib
        return lib
