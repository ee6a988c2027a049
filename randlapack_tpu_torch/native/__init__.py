"""Native (C++) Matrix Market reader and writer (counterpart of
``randlapack_tpu/native/__init__.py``): ``fast_mm_read``, ``fast_mm_write``
and ``HAVE_NATIVE``. ``fast_mm.cpp`` here is compiled with ``g++`` into
``build/native/`` on first use (``_build.load_native``), never on import.
Where it cannot be built (no ``g++``, or the build fails) both functions
raise ``ImportError``, as the JAX package's stubs do, and ``HAVE_NATIVE``
is False; ``HAVE_NATIVE`` tries the build the first time it is read."""
from __future__ import annotations

__all__ = ["fast_mm_read", "fast_mm_write", "HAVE_NATIVE"]


def _module():
    from ..extras.io import native_module
    mod = native_module()
    if mod is None:
        raise ImportError("the native extension could not be built "
                          "(g++ missing or the build failed)")
    return mod


def fast_mm_read(path):
    """Read a Matrix Market coordinate file: ``(rows, cols, vals, m, n)``
    with int32 indices (0-based) and f64 values."""
    return _module().fast_mm_read(str(path))


def fast_mm_write(path, rows, cols, vals, m, n):
    """Write a general real coordinate Matrix Market file (values as
    ``%.17g``); ``rows``/``cols`` int32, ``vals`` f64 arrays."""
    return _module().fast_mm_write(str(path), rows, cols, vals, m, n)


def __getattr__(name):
    if name == "HAVE_NATIVE":
        from ..extras.io import native_module
        return native_module() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
