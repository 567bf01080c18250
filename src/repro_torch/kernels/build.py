"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` alone (no PyTorch headers) into its own shared library under
``<repo>/build/repro_torch_kernels/``, then loaded with ``ctypes``.  The
library's file name carries a hash of the source and its flags, so an edit
rebuilds and an unchanged source is built once per checkout.
:func:`build_all` starts one ``nvcc`` per source, all at once, and waits
for them together.  ``-Xptxas -v`` makes ``nvcc`` report each kernel's
registers, shared memory and spills; the log is kept beside the library
and :func:`ptxas_info` reads it.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
SOURCES = ("weighted_agg", "kmeans", "flash_attention", "flash_attention_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")
# flags of one source only: the tensor-core flash kernel finds libcuda's
# cuTensorMapEncodeTiled with dlopen
EXTRA_FLAGS = {"flash_attention_sm90": ("-ldl",)}
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default location.  Raises a clear error when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the repro_torch CUDA kernels are compiled "
        "at first use and need the CUDA toolkit; CPU tensors take the "
        "plain PyTorch path and need no build")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every source in ``names`` that has no current library, one
    ``nvcc`` per source, all started together.  Returns the seconds spent
    (0.0 when everything was built already)."""
    todo = [(n, _lib_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)      # atomic: a racing build is harmless
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_info(name: str) -> List[dict]:
    """Each kernel of ``csrc/<name>.cu`` as ptxas reported it when the
    current library was built: name, registers, shared memory and spill
    bytes, and any ptxas warning (an ignored ``setmaxnreg``, say)."""
    log = _lib_path(name).with_suffix(".log").read_text(errors="replace")
    kernels: Dict[str, dict] = {}
    cur = None
    warnings = []
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            cur = kernels.setdefault(m.group(1), {"kernel": m.group(1)})
            continue
        if "warning" in line or "Performance Loss" in line:
            warnings.append(line.strip())
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    rows = [k for k in kernels.values() if "registers" in k]
    return rows + ([{"warnings": warnings}] if warnings else [])


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib: Optional[ctypes.CDLL] = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LOADED[name] = lib
    return lib
