"""A persistent JAX compilation cache that the test processes of one run
share, so that a program the JAX package compiles in one test file is
loaded, not compiled again, in the others (the port's test files hold
the JAX package's pipelines on the same few shapes; its XLA compiles are
most of their time on the CPU).

Imported by the port's test files that run the JAX package: every
process of a run (each pytest-xdist worker imports every test file while
it collects) caches under ``build/jax_cache/`` in the checkout, which git
ignores.  An entry is keyed by the program and its compile options, so a
stale one is never loaded.  The cache has no size limit: with one, JAX
takes a lock and lists the whole directory at every write, which
serialised the processes (a run took longer than without the cache).  A
process that reads an entry while another writes it fails to decode it,
warns and compiles the program itself.

The settings hold for the whole process from the import on.  A
pytest-xdist worker imports every test file while it collects, before it
runs a test, so in a run of the whole suite every test, the JAX
package's own included, runs with the cache; a run of the JAX package's
test files alone runs without it.

``reset_cache`` is JAX's private ``jax._src.compilation_cache.reset_cache``,
checked against jax 0.9.0: a JAX without it fails here, by name."""

from pathlib import Path

import jax
from jax._src import compilation_cache

if not callable(getattr(compilation_cache, "reset_cache", None)):
    raise ImportError(f"jax {jax.__version__} has no jax._src.compilation_cache.reset_cache "
                      "(tests/jax_compile_cache.py was checked against jax 0.9.0)")

CACHE_DIR = Path(__file__).resolve().parents[1] / "build" / "jax_cache"

jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
# a program compiled before this import (another test file's, at its
# import) has fixed the process's choice without the cache: choose again
compilation_cache.reset_cache()
