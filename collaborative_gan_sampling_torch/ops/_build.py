"""Builds the hand-written CUDA kernels of ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc`` for
Hopper (``sm_90a``) into its own shared library, which is loaded with
``ctypes``. Libraries go to ``build/kernels/`` beside the package (listed in
``.gitignore``) under a name that carries a hash of the source, the headers
of ``csrc/`` and the flags, so an edited source or header is rebuilt and an
unchanged one is reused. ``build()`` starts one ``nvcc`` per source, all at
once.

Every C entry returns the ``cudaError_t`` of its launch. ``launch`` is the
one way the kernel modules call an entry: it declares the entry on its
first call from the argument types that its module states once, passes
tensors as their pointers and the stream last, and raises when the error
is not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("drs_accept", "conv_refine28", "conv_refine28_bf16", "refine_mlp",
           "d_epilogue_bf16")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# The declared C entries, by (library, entry name).
_ENTRIES: dict[tuple[ctypes.CDLL, str], ctypes._CFuncPtr] = {}

# The ``cgs`` namespace of custom ops (``ops/registry.py``); the ops stay
# registered while this object lives.
OPS = torch.library.Library("cgs", "DEF")


def define_op(schema: str, cpu, cuda, fake, wrapper) -> None:
    """Define the op ``cgs::<schema>`` with its CPU implementation (the
    plain version), its CUDA implementation (the kernel's launch) and its
    fake implementation (the output shapes, for ``torch.export``). Each
    CUDA call that returns counts one on ``wrapper.launches`` (the function
    that calls the op), a launch from a reloaded ``torch.export`` artifact
    too. The implementations are registered on the dispatcher directly: no
    autograd formula (an op whose output needs one registers it beside,
    with ``torch.library.register_autograd``) and no Python layer but the
    count, where ``torch.library.custom_op`` adds ~20 us a call."""
    name = schema.split("(", 1)[0]

    def counted(*args):
        out = cuda(*args)
        wrapper.launches += 1
        return out

    wrapper.launches = 0
    OPS.define(schema)
    OPS.impl(name, cpu, "CPU")
    OPS.impl(name, counted, "CUDA")
    torch.library.register_fake(f"cgs::{name}", fake, lib=OPS)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the machine with the card")


def lib_path(name: str) -> Path:
    """Where kernel ``name``'s library goes: its name carries a hash of the
    source, of every header in ``csrc/`` (a source may include any) and of
    the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, str]:
    """Compile every library of ``names`` that is missing, one ``nvcc`` per
    source, all started together. Returns each kernel's ptxas report
    (registers, shared memory, spills); '' where the library was cached."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def open_lib(path: Path) -> ctypes.CDLL:
    """Load one kernel library and declare its error-string entry."""
    lib = ctypes.CDLL(str(path))
    lib.cgs_error_string.restype = ctypes.c_char_p
    lib.cgs_error_string.argtypes = [ctypes.c_int]
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    if name not in _LIBS:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        _LIBS[name] = open_lib(path)
    return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cgs_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def launch(lib: ctypes.CDLL, name: str, argtypes, *args) -> None:
    """Calls C entry ``name`` of ``lib`` (a kernel's build from ``load``,
    or another build of the same source from ``open_lib``) on ``args``,
    each tensor as its data pointer, and the current stream of the first
    argument's device (a tensor's) last. ``argtypes`` are the entry's
    arguments before the stream, as its kernel module states them; the
    entry is declared with them, returning a ``cudaError_t``, at its first
    call on ``lib``. Raises with the library's error string when that
    error is not 0."""
    fn = _ENTRIES.get((lib, name))
    if fn is None:
        fn = _ENTRIES[lib, name] = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [*argtypes, ctypes.c_void_p]
    err = fn(*[ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
               else a for a in args], stream_of(args[0]))
    check(lib, err, name)


def unaliased(x0, out):
    """A plain version's (x_K, logits) as an op's outputs, which may not
    alias its inputs: x_K is x0 itself at K = 0."""
    x_k, logits = out
    return (x_k.clone() if x_k.data_ptr() == x0.data_ptr() else x_k), logits


def check_device(t, what: str) -> None:
    """An op has a CUDA and a CPU implementation and no other: raise the
    wrappers' error for a tensor elsewhere (before the dispatcher would
    take a fake implementation for it)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {t.device}")


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@contextlib.contextmanager
def autograd_inside_op():
    """Lets autograd record inside a custom op's implementation, which the
    dispatcher runs below the autograd keys (``torch.autograd.grad`` there
    would find no graph): for the plain versions that refine by autograd."""
    exclude = torch._C._dispatch_tls_local_exclude_set()
    for key in (torch._C.DispatchKey.AutogradFunctionality,
                torch._C.DispatchKey.ADInplaceOrView):
        exclude = exclude.remove(key)
    with torch._C._ForceDispatchKeyGuard(
            torch._C._dispatch_tls_local_include_set(), exclude):
        yield
