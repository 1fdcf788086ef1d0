"""One JAX compilation cache for a test module that runs the reference's
eager code.

Eager, the reference traces and compiles its scans, loops and vmaps anew
at every call (a new closure is a new function to ``jax.jit``), so a
module that runs its receivers on many subframes compiles the same XLA
programs again and again: the reference's one eNB frame compiles 524
programs, most of them repeats.  A persistent compilation cache keyed by
the program (XLA's own fingerprint, not the Python function) serves every
repeat from the first compile.  It lives in a fresh temporary directory
for the module and is removed after it; the process's JAX settings are
restored, so the next module on the same worker compiles as before.  It
changes no value: a cached executable is the compiled program itself.
"""

import contextlib
import shutil
import tempfile

import jax
from jax._src import compilation_cache

_SETTINGS = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")


@contextlib.contextmanager
def compile_once():
    """Within the block, every program compiled is cached and compiled
    once (entries of any size and compile time)."""
    saved = {k: getattr(jax.config, k) for k in _SETTINGS}
    path = tempfile.mkdtemp(prefix="lteax_jax_cache_")
    compilation_cache.reset_cache()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    try:
        yield path
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()
        shutil.rmtree(path, ignore_errors=True)
